// mgl-tpu native runtime components (C ABI, loaded via ctypes).
//
// Host-side equivalents of the reference's C++ runtime (SURVEY.md §2.1
// N7/N9/N11): the float64 rescue tier of the PairHMM precision cascade,
// ScoreMax bookkeeping and the mapper's seeding run on the host CPU while
// the f32/int32 hot paths run on the device.  Implementations are written
// fresh from the recurrences (compute_prob_scalar.cc:39-43 semantics,
// sw.cpp:100-127 ScoreMax rules); no reference code is copied.
//
// Threading uses std::thread over an atomic work queue — the stand-in for
// the reference's TBB parallel_for over reads
// (com_microsoft_mgl_pairhmm_MicrosoftPairHmm.cc:131).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PairHMM float64 rescue kernel.
//
// One call scores a batch of (read, hap) pairs in double precision.
// Inputs are flat arrays with per-pair offsets; transition rows are
// precomputed by the caller (host NumPy, from the canonical tables) so this
// kernel is pure arithmetic:
//   p_* : per-pair rows, length (rslen+1), index 0 unused (zero)
//   distm_match / distm_mis: emission rows, same layout
// Output: scaled scores (x 2^1020 / haplen), one double per pair.
// ---------------------------------------------------------------------------

static void score_pair_f64(
    const uint8_t* read, int32_t rslen,
    const uint8_t* hap, int32_t haplen,
    const double* p_mm, const double* p_gapm, const double* p_mx,
    const double* p_my, const double* p_zz,
    const double* dm, const double* dmm,
    double y_init, double* out)
{
    const int rows = rslen + 1;
    // column-sweep with three rolling columns; X has an intra-column
    // first-order recurrence handled serially down the rows.
    std::vector<double> M_prev(rows, 0.0), X_prev(rows, 0.0), Y_prev(rows, 0.0);
    std::vector<double> M_cur(rows), X_cur(rows), Y_cur(rows);
    Y_prev[0] = y_init;

    double result = 0.0;
    for (int c = 1; c <= haplen; c++) {
        const uint8_t hc = hap[c - 1];
        M_cur[0] = 0.0;
        X_cur[0] = 0.0;
        Y_cur[0] = y_init;
        for (int r = 1; r < rows; r++) {
            const uint8_t rc = read[r - 1];
            const bool match = (rc == hc) | (rc == 'N') | (hc == 'N');
            const double distm = match ? dm[r] : dmm[r];
            M_cur[r] = distm * (M_prev[r - 1] * p_mm[r] +
                                (X_prev[r - 1] + Y_prev[r - 1]) * p_gapm[r]);
            Y_cur[r] = M_prev[r] * p_my[r] + Y_prev[r] * p_zz[r];
            X_cur[r] = M_cur[r - 1] * p_mx[r] + X_cur[r - 1] * p_zz[r];
        }
        result += M_cur[rows - 1] + X_cur[rows - 1];
        M_prev.swap(M_cur);
        X_prev.swap(X_cur);
        Y_prev.swap(Y_cur);
    }
    *out = result;
}

// Batch driver.  reads/haps are concatenated; offsets index into them.
void pairhmm_f64_batch(
    int32_t n_pairs,
    const uint8_t* reads, const int64_t* read_off, const int32_t* rslen,
    const uint8_t* haps, const int64_t* hap_off, const int32_t* haplen,
    const double* trans,            // (n_pairs, 7, max_rows) row-major
    int64_t trans_stride,           // = 7 * max_rows
    int64_t row_stride,             // = max_rows
    const double* y_init,
    double* out,
    int32_t n_threads)
{
    std::atomic<int32_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int32_t i = next.fetch_add(1);
            if (i >= n_pairs) return;
            const double* t = trans + i * trans_stride;
            score_pair_f64(
                reads + read_off[i], rslen[i],
                haps + hap_off[i], haplen[i],
                t + 0 * row_stride, t + 1 * row_stride, t + 2 * row_stride,
                t + 3 * row_stride, t + 4 * row_stride,
                t + 5 * row_stride, t + 6 * row_stride,
                y_init[i], out + i);
        }
    };
    if (n_threads <= 1) {
        worker();
        return;
    }
    std::vector<std::thread> pool;
    for (int32_t k = 0; k < n_threads; k++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// ScoreMax (ez) bookkeeping from the kernel's last-col/last-row samples.
// Mirrors sw.cpp:100-127 including the >= last-column rule and the
// last-row tie-closer-to-diagonal rule.  lc/lr: (Dm, n_lanes) int32.
// ---------------------------------------------------------------------------
void score_max_batch(
    int32_t n_pairs,
    const int32_t* lc, const int32_t* lr,
    int64_t row_stride,          // = n_lanes
    const int32_t* lane,         // lane index per pair
    const int32_t* tlen, const int32_t* qlen,
    int32_t* mqe, int32_t* mqe_t,
    int32_t* max_, int32_t* max_t, int32_t* max_q, int32_t* seg_length)
{
    for (int32_t b = 0; b < n_pairs; b++) {
        const int32_t tl = tlen[b], ql = qlen[b], ln = lane[b];
        int32_t best = INT32_MIN, best_t = -1;
        for (int32_t i = 1; i <= tl; i++) {
            int32_t v = lc[(int64_t)(i + ql - 2) * row_stride + ln];
            if (v >= best) { best = v; best_t = i; }
        }
        int32_t mx = best, mx_t = best_t, mx_q = ql, seg = 0;
        for (int32_t j = 1; j <= ql; j++) {
            int32_t v = lr[(int64_t)(tl + j - 2) * row_stride + ln];
            if (v > mx || (v == mx && std::abs(tl - j) < std::abs(mx_t - mx_q))) {
                mx = v; mx_t = tl; mx_q = j; seg = ql - j;
            }
        }
        mqe[b] = best; mqe_t[b] = best_t;
        max_[b] = mx; max_t[b] = mx_t; max_q[b] = mx_q; seg_length[b] = seg;
    }
}

// ---------------------------------------------------------------------------
// Stable LSD radix sort of the k-mer index rows (uint32 key, uint32
// position, uint8 strand-bit), 16-bit digits.  Replaces
// np.argsort(kind="stable") + three permutation gathers in
// ReferenceIndex.build: the payload columns move with the key inside the
// scatter, so no separate gather passes (or pack/unpack passes) exist at
// all.  Stability preserves the ascending-position order within equal
// k-mers that the numpy path produces — outputs are bit-identical to it.
// key_bits (= 2k for k-mers) bounds the number of passes; a pass whose
// digit is constant across the array skips its scatter.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// Single-pass canonical k-mer scan (k <= 16).  Rolls the forward value
// ((v << 2) | code, masked to 2k bits) and its reverse complement
// ((v >> 2) | (3 - code) << 2(k-1)) together, tracks the distance since
// the last ambiguous base for validity, and emits
// (min(fwd, rc), position, fwd <= rc) rows for every valid k-mer —
// exactly the rows the numpy _kmers/_rc_kmers/mask pipeline produces,
// without its log-doubling temporaries.  Returns the row count.
// ---------------------------------------------------------------------------

int64_t kmer_scan_canonical(int64_t ref_len, const uint8_t* code, int32_t k,
                            uint32_t* keys, uint32_t* pos, uint8_t* fwd)
{
    const uint32_t mask = (k == 16) ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1u);
    const int rc_shift = 2 * (k - 1);
    uint32_t fv = 0, rv = 0;
    int64_t run = 0, n = 0;
    for (int64_t i = 0; i < ref_len; i++) {
        const uint32_t c = code[i];
        if (c >= 4) {
            run = 0;
            continue;
        }
        fv = ((fv << 2) | c) & mask;
        rv = (rv >> 2) | ((3u - c) << rc_shift);
        if (++run >= k) {
            const uint32_t canon = fv < rv ? fv : rv;
            keys[n] = canon;
            pos[n] = (uint32_t)(i - k + 1);
            fwd[n] = fv <= rv;
            n++;
        }
    }
    return n;
}

// Prefix jump table over the SORTED key column: table[b] = number of
// keys whose (key >> shift) bucket is < b, so [table[p], table[p+1]) is
// bucket p's row range.  Counting over sorted keys walks the table
// monotonically (cache-resident), unlike np.bincount's int64 temp +
// 536 MB scatter.  table has buckets+1 uint32 entries (n < 2^32).
void kmer_prefix_table(int64_t n, const uint32_t* keys, int32_t shift,
                       int64_t buckets, uint32_t* table)
{
    std::memset(table, 0, (buckets + 1) * sizeof(uint32_t));
    for (int64_t i = 0; i < n; i++)
        table[(keys[i] >> shift) + 1]++;
    uint64_t sum = 0;
    for (int64_t b = 1; b <= buckets; b++) {
        sum += table[b];
        table[b] = (uint32_t)sum;
    }
}

// ---------------------------------------------------------------------------
// Fused seeding engine: seed k-mers -> canonical index lookup -> diagonal
// voting, one pass per read.  The exact single-core replacement for the
// NumPy pipeline mapper._seed_kmers + ReferenceIndex.lookup +
// mapper._vote_diagonals (two-strand canonical mode): that path makes ~14
// full-array passes per chunk (seed value build, prefix gathers, hit
// expansion via np.repeat, two np.unique sorts over millions of hit keys);
// here every read's <=S*max_hits hits stay in L1 and are voted in place.
// Outputs are bit-identical to the NumPy path (regression-tested), rows
// laid out like _vote_diagonals: forward rows [0,N) then reverse [N,2N).
// ---------------------------------------------------------------------------

static const uint8_t* code_table()
{
    static uint8_t t[256];
    static bool init = false;
    if (!init) {
        std::memset(t, 4, sizeof(t));
        const char* b = "ACGTacgt";
        for (int i = 0; i < 8; i++) t[(uint8_t)b[i]] = i & 3;
        init = true;
    }
    return t;
}

static inline uint32_t rc_kmer32(uint32_t v, int32_t k)
{
    v = ~v;
    v = ((v >> 2) & 0x33333333u) | ((v & 0x33333333u) << 2);
    v = ((v >> 4) & 0x0F0F0F0Fu) | ((v & 0x0F0F0F0Fu) << 4);
    v = __builtin_bswap32(v);
    return v >> (32 - 2 * k);
}

// Vote one row's diagonals: best bin (diag>>3) by count, ties -> largest
// bin; exact diagonal = most-supported diag inside the best bin, ties ->
// largest diag; runner-up = same rule over bins NOT adjacent to the winner.
// Mirrors mapper._best_locus's lexsort tie-breaking exactly.
static void vote_row(int64_t* d, int32_t n, int64_t ref_len,
                     int64_t* pos, int32_t* votes,
                     int32_t* votes2, int64_t* pos2)
{
    *pos = -1; *votes = 0; *votes2 = 0; *pos2 = -1;
    if (n == 0) return;
    std::sort(d, d + n);

    auto best_of = [&](bool skip_adj, int64_t win_bin,
                       int32_t* out_votes, int64_t* out_pos) {
        int32_t best_cnt = 0;
        int32_t bs = -1, be = -1;           // winning bin's [start, end)
        for (int32_t i = 0; i < n;) {
            const int64_t bin = d[i] >> 3;
            int32_t j = i;
            while (j < n && (d[j] >> 3) == bin) j++;
            const bool adj = skip_adj &&
                (bin - win_bin <= 1 && win_bin - bin <= 1);
            if (!adj && (j - i) >= best_cnt) {
                best_cnt = j - i; bs = i; be = j;
            }
            i = j;
        }
        if (best_cnt == 0) return (int64_t)(-(1ll << 60));
        // most-supported exact diagonal inside the winning bin
        int32_t dc = 0;
        int64_t dd = -1;
        for (int32_t i = bs; i < be;) {
            int32_t j = i;
            while (j < be && d[j] == d[i]) j++;
            if ((j - i) >= dc) { dc = j - i; dd = d[i]; }
            i = j;
        }
        *out_votes = best_cnt;
        *out_pos = (dd >= 0) ? (dd < ref_len ? dd : ref_len - 1) : -1;
        return d[bs] >> 3;                  // the winning bin id
    };

    const int64_t win_bin = best_of(false, 0, votes, pos);
    best_of(true, win_bin, votes2, pos2);
}

void map_seed_vote(
    int32_t n_reads, int32_t read_len,
    const uint8_t* reads,                 // (N, L) ASCII
    int32_t k, int32_t stride,
    const uint32_t* sorted_kmers,         // (M,) canonical values
    const uint32_t* positions,            // (M,) ref offsets
    const uint8_t* canon_fwd,             // (M,) fwd-is-canonical bits
    int64_t M,
    const uint32_t* ptable,               // (buckets+1,) or NULL
    int32_t pshift,
    int32_t max_hits, int64_t ref_len,
    int32_t n_threads,
    // outputs: 2N rows (forward rows then reverse rows)
    int64_t* pos, int32_t* votes, int32_t* votes2, int64_t* pos2)
{
    const uint8_t* ct = code_table();
    const int32_t S = (read_len - k) / stride + 1;
    std::atomic<int32_t> next(0);
    const int32_t BLOCK = 256;

    auto worker = [&]() {
        std::vector<int64_t> fw, rc;
        fw.reserve((size_t)S * max_hits);
        rc.reserve((size_t)S * max_hits);
        // Per-read seed slots: the lookup chain (ptable -> sorted_kmers
        // -> positions/canon_fwd) is one dependent cache miss after
        // another into multi-GB tables at genome scale; staging all S
        // seeds per read with prefetches between stages keeps ~S
        // independent misses in flight instead of serializing them.
        // Outputs are byte-identical (same hits, same s/j order).
        struct Slot {
            uint32_t look;
            int64_t lo, hi;
            int32_t off;
            uint8_t valid, b_read;
        };
        std::vector<Slot> sl((size_t)S);
        for (;;) {
            const int32_t b0 = next.fetch_add(BLOCK);
            if (b0 >= n_reads) return;
            const int32_t b1 = b0 + BLOCK < n_reads ? b0 + BLOCK : n_reads;
            for (int32_t r = b0; r < b1; r++) {
                const uint8_t* rd = reads + (int64_t)r * read_len;
                fw.clear(); rc.clear();
                // stage A: decode k-mers, prefetch jump-table entries
                for (int32_t s = 0; s < S; s++) {
                    const int32_t off = s * stride;
                    uint32_t fv = 0;
                    bool valid = true;
                    for (int32_t j = 0; j < k; j++) {
                        const uint32_t c = ct[rd[off + j]];
                        if (c >= 4) { valid = false; break; }
                        fv = (fv << 2) | c;
                    }
                    sl[s].valid = valid;
                    if (!valid) continue;
                    const uint32_t rv = rc_kmer32(fv, k);
                    const uint32_t look = fv < rv ? fv : rv;
                    sl[s].look = look;
                    sl[s].b_read = fv <= rv;
                    sl[s].off = off;
                    if (ptable)
                        __builtin_prefetch(ptable + (look >> pshift));
                }
                // stage B: bucket ranges, prefetch the key scan window
                for (int32_t s = 0; s < S; s++) {
                    if (!sl[s].valid) continue;
                    if (ptable) {
                        const uint32_t p = sl[s].look >> pshift;
                        sl[s].lo = ptable[p]; sl[s].hi = ptable[p + 1];
                    } else {
                        sl[s].lo = 0; sl[s].hi = M;
                    }
                    if (sl[s].hi > sl[s].lo) {
                        __builtin_prefetch(sorted_kmers + sl[s].lo);
                        __builtin_prefetch(sorted_kmers + sl[s].lo + 16);
                    }
                }
                // stage C: narrow to the exact [lo, hi) run, prefetch
                // the payload rows it will gather
                for (int32_t s = 0; s < S; s++) {
                    if (!sl[s].valid) continue;
                    int64_t lo = sl[s].lo, hi = sl[s].hi;
                    const uint32_t look = sl[s].look;
                    if (hi - lo > 128) {
                        const uint32_t* a = sorted_kmers;
                        auto* l = std::lower_bound(a + lo, a + hi, look);
                        auto* u = std::upper_bound(l, a + hi, look);
                        lo = l - a; hi = u - a;
                    } else {
                        while (lo < hi && sorted_kmers[lo] < look) lo++;
                        int64_t e = lo;
                        while (e < hi && sorted_kmers[e] == look) e++;
                        hi = e;
                    }
                    const int64_t cnt = hi - lo;
                    if (cnt == 0 || cnt > max_hits) {
                        sl[s].valid = 0;
                        continue;
                    }
                    sl[s].lo = lo; sl[s].hi = hi;
                    __builtin_prefetch(positions + lo);
                    __builtin_prefetch(canon_fwd + lo);
                }
                // stage D: gather hits (original order preserved)
                for (int32_t s = 0; s < S; s++) {
                    if (!sl[s].valid) continue;
                    const int32_t off = sl[s].off;
                    const bool b_read = sl[s].b_read != 0;
                    const int64_t roff = read_len - k - off;
                    for (int64_t j = sl[s].lo; j < sl[s].hi; j++) {
                        const int64_t hp = (int64_t)positions[j];
                        if ((canon_fwd[j] != 0) != b_read)   // reverse hit
                            rc.push_back(hp - roff);
                        else
                            fw.push_back(hp - off);
                    }
                }
                vote_row(fw.data(), (int32_t)fw.size(), ref_len,
                         pos + r, votes + r, votes2 + r, pos2 + r);
                vote_row(rc.data(), (int32_t)rc.size(), ref_len,
                         pos + n_reads + r, votes + n_reads + r,
                         votes2 + n_reads + r, pos2 + n_reads + r);
            }
        }
    };
    if (n_threads <= 1) { worker(); return; }
    std::vector<std::thread> pool;
    for (int32_t t = 0; t < n_threads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}

// Mismatch count of each read vs the reference at its predicted start
// (the certified-diagonal / exact-tier input).  Out-of-range columns are
// clamped to the last reference byte, matching the NumPy
// np.clip(rd_idx, 0, ref_len-1) gather exactly (those rows are
// edge-clipped and handled separately by the caller).
void exact_nm_batch(int32_t n, int32_t L, const uint8_t* reads,
                    const uint8_t* ref, int64_t ref_len,
                    const int64_t* pos, int32_t* nm, int32_t n_threads)
{
    std::atomic<int32_t> next(0);
    const int32_t BLOCK = 1024;
    auto worker = [&]() {
        for (;;) {
            const int32_t b0 = next.fetch_add(BLOCK);
            if (b0 >= n) return;
            const int32_t b1 = b0 + BLOCK < n ? b0 + BLOCK : n;
            for (int32_t r = b0; r < b1; r++) {
                const uint8_t* rd = reads + (int64_t)r * L;
                const int64_t p = pos[r];
                int32_t bad = 0;
                if (p >= 0 && p + L <= ref_len) {
                    const uint8_t* rf = ref + p;
                    for (int32_t j = 0; j < L; j++) bad += rf[j] != rd[j];
                } else {
                    for (int32_t j = 0; j < L; j++) {
                        int64_t i = p + j;
                        if (i < 0) i = 0;
                        if (i >= ref_len) i = ref_len - 1;
                        bad += ref[i] != rd[j];
                    }
                }
                nm[r] = bad;
            }
        }
    };
    if (n_threads <= 1) { worker(); return; }
    std::vector<std::thread> pool;
    for (int32_t t = 0; t < n_threads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}

void radix_sort_kmer_index(int64_t n, int32_t key_bits,
                           uint32_t* keys, uint32_t* pos, uint8_t* fwd)
{
    if (n <= 1) return;
    const int passes = (key_bits + 15) / 16;
    std::vector<uint32_t> kscr(n), pscr(n);
    std::vector<uint8_t> fscr(n);
    std::vector<int64_t> count(65536);
    uint32_t* ksrc = keys;        uint32_t* psrc = pos;
    uint8_t*  fsrc = fwd;
    uint32_t* kdst = kscr.data(); uint32_t* pdst = pscr.data();
    uint8_t*  fdst = fscr.data();

    for (int p = 0; p < passes; p++) {
        const int shift = 16 * p;
        std::memset(count.data(), 0, 65536 * sizeof(int64_t));
        for (int64_t i = 0; i < n; i++)
            count[(ksrc[i] >> shift) & 0xFFFF]++;
        bool constant = false;
        int64_t sum = 0;
        for (int b = 0; b < 65536; b++) {
            if (count[b] == n) { constant = true; break; }
            const int64_t c = count[b];
            count[b] = sum;
            sum += c;
        }
        if (constant) continue;  // digit identical everywhere: order kept
        for (int64_t i = 0; i < n; i++) {
            const int64_t d = count[(ksrc[i] >> shift) & 0xFFFF]++;
            kdst[d] = ksrc[i];
            pdst[d] = psrc[i];
            fdst[d] = fsrc[i];
        }
        std::swap(ksrc, kdst);
        std::swap(psrc, pdst);
        std::swap(fsrc, fdst);
    }
    if (ksrc != keys) {
        std::memcpy(keys, ksrc, n * sizeof(uint32_t));
        std::memcpy(pos, psrc, n * sizeof(uint32_t));
        std::memcpy(fwd, fsrc, n * sizeof(uint8_t));
    }
}

}  // extern "C"
