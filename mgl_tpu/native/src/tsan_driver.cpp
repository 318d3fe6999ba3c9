// ThreadSanitizer driver for the threaded native batch APIs.
//
// The reference relies on TBB's tested scheduler for its fan-out
// (com_microsoft_mgl_pairhmm_MicrosoftPairHmm.cc:131); our stand-in is a
// hand-rolled atomic work queue (mgl_native.cpp), so this harness runs the
// threaded entry points under -fsanitize=thread and also checks that
// 1-thread and N-thread runs produce byte-identical outputs (the
// disjoint-write contract).  Built and run by tests/test_native_tsan.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {
void pairhmm_f64_batch(
    int32_t n_pairs,
    const uint8_t* reads, const int64_t* read_off, const int32_t* rslen,
    const uint8_t* haps, const int64_t* hap_off, const int32_t* haplen,
    const double* trans, int64_t trans_stride, int64_t row_stride,
    const double* y_init, double* out, int32_t n_threads);

int64_t kmer_scan_canonical(int64_t ref_len, const uint8_t* code, int32_t k,
                            uint32_t* keys, uint32_t* pos, uint8_t* fwd);
void radix_sort_kmer_index(int64_t n, int32_t key_bits,
                           uint32_t* keys, uint32_t* pos, uint8_t* fwd);
void map_seed_vote(
    int32_t n_reads, int32_t read_len, const uint8_t* reads,
    int32_t k, int32_t stride,
    const uint32_t* sorted_kmers, const uint32_t* positions,
    const uint8_t* canon_fwd, int64_t M,
    const uint32_t* ptable, int32_t pshift,
    int32_t max_hits, int64_t ref_len, int32_t n_threads,
    int64_t* pos, int32_t* votes, int32_t* votes2, int64_t* pos2);
void exact_nm_batch(int32_t n, int32_t L, const uint8_t* reads,
                    const uint8_t* ref, int64_t ref_len,
                    const int64_t* pos, int32_t* nm, int32_t n_threads);
}

static uint32_t rng_state = 12345;
static uint32_t xorshift() {
    rng_state ^= rng_state << 13;
    rng_state ^= rng_state >> 17;
    rng_state ^= rng_state << 5;
    return rng_state;
}

int main() {
    const int32_t N = 512, RL = 50, HL = 80;
    const char* ACGT = "ACGT";

    // ---- pairhmm_f64_batch ----
    std::vector<uint8_t> reads(N * RL), haps(N * HL);
    std::vector<int64_t> roff(N), hoff(N);
    std::vector<int32_t> rsl(N, RL), hl(N, HL);
    for (int i = 0; i < N * RL; i++) reads[i] = ACGT[xorshift() & 3];
    for (int i = 0; i < N * HL; i++) haps[i] = ACGT[xorshift() & 3];
    for (int i = 0; i < N; i++) { roff[i] = (int64_t)i * RL; hoff[i] = (int64_t)i * HL; }
    const int64_t rows = RL + 1, tstride = 7 * rows;
    std::vector<double> trans(N * tstride);
    for (auto& t : trans) t = 0.1 + (xorshift() & 0xFF) / 512.0;
    std::vector<double> yi(N, 1e10);
    std::vector<double> out1(N), outN(N);
    pairhmm_f64_batch(N, reads.data(), roff.data(), rsl.data(),
                      haps.data(), hoff.data(), hl.data(), trans.data(),
                      tstride, rows, yi.data(), out1.data(), 1);
    pairhmm_f64_batch(N, reads.data(), roff.data(), rsl.data(),
                      haps.data(), hoff.data(), hl.data(), trans.data(),
                      tstride, rows, yi.data(), outN.data(), 4);
    if (memcmp(out1.data(), outN.data(), N * sizeof(double)) != 0) {
        fprintf(stderr, "FAIL: f64 batch 1-thread != 4-thread\n");
        return 1;
    }

    // ---- map_seed_vote + exact_nm_batch (the fused seeding engine) ----
    const int64_t REF = 200000;
    const int32_t K = 16, NL = 120, NR = 800;
    std::vector<uint8_t> refb(REF), code(REF);
    for (int64_t i = 0; i < REF; i++) {
        refb[i] = ACGT[xorshift() & 3];
        code[i] = (uint8_t)(strchr(ACGT, refb[i]) - ACGT);
    }
    std::vector<uint32_t> keys(REF), pos(REF);
    std::vector<uint8_t> fwd(REF);
    const int64_t M = kmer_scan_canonical(REF, code.data(), K, keys.data(),
                                          pos.data(), fwd.data());
    radix_sort_kmer_index(M, 2 * K, keys.data(), pos.data(), fwd.data());
    std::vector<uint8_t> rd(NR * NL);
    std::vector<int64_t> rstart(NR);
    for (int r = 0; r < NR; r++) {
        const int64_t s = xorshift() % (REF - NL);
        rstart[r] = s;
        for (int j = 0; j < NL; j++) rd[r * NL + j] = refb[s + j];
        rd[r * NL + (xorshift() % NL)] = ACGT[xorshift() & 3];
    }
    std::vector<int64_t> p1(2 * NR), p2(2 * NR), pN1(2 * NR), pN2(2 * NR);
    std::vector<int32_t> v1(2 * NR), w1(2 * NR), vN(2 * NR), wN(2 * NR);
    map_seed_vote(NR, NL, rd.data(), K, K, keys.data(), pos.data(),
                  fwd.data(), M, nullptr, 0, 64, REF, 1,
                  p1.data(), v1.data(), w1.data(), p2.data());
    map_seed_vote(NR, NL, rd.data(), K, K, keys.data(), pos.data(),
                  fwd.data(), M, nullptr, 0, 64, REF, 4,
                  pN1.data(), vN.data(), wN.data(), pN2.data());
    if (memcmp(p1.data(), pN1.data(), p1.size() * 8) != 0 ||
        memcmp(v1.data(), vN.data(), v1.size() * 4) != 0 ||
        memcmp(w1.data(), wN.data(), w1.size() * 4) != 0 ||
        memcmp(p2.data(), pN2.data(), p2.size() * 8) != 0) {
        fprintf(stderr, "FAIL: map_seed_vote 1-thread != 4-thread\n");
        return 1;
    }
    std::vector<int32_t> nm1(NR), nmN(NR);
    exact_nm_batch(NR, NL, rd.data(), refb.data(), REF, rstart.data(),
                   nm1.data(), 1);
    exact_nm_batch(NR, NL, rd.data(), refb.data(), REF, rstart.data(),
                   nmN.data(), 4);
    if (memcmp(nm1.data(), nmN.data(), NR * 4) != 0) {
        fprintf(stderr, "FAIL: exact_nm 1-thread != 4-thread\n");
        return 1;
    }

    printf("tsan driver OK: seeded=%d\n", (int)(p1[0] >= 0));
    return 0;
}
