// Golden-vector oracle harness.
//
// Compiles the *reference* kernels (from /root/reference, via include path —
// no sources are copied into this repo) and drives them over test vectors so
// the rebuild can assert parity.  Modes:
//
//   tables  <out_dir>    — dump Context<float>/<double> tables as raw binary
//   sw                   — stdin lines: "target query match mismatch open ext strategy"
//                          stdout: "scalar_cigar scalar_offset avx_cigar avx_offset"
//   pairhmm              — stdin lines: "hap read q,... i,... d,... c,..."
//                          stdout: "%a-hex scalarf scalard avxf avxd" scores
//
// FTZ is enabled as the reference JNI init does
// (com_microsoft_mgl_pairhmm_MicrosoftPairHmm.cc:57).

#include <cstdio>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>
#include <sstream>
#include <iostream>

#include <x86intrin.h>

#include "sw_scalar.h"
#include "sw_avx.h"
#include "pairhmm_common.h"
#include "compute_prob_scalar.h"
#include "compute_prob_avx.h"

float compute_fast_prob_float(readinfo &read, std::vector<hapinfo> &hap_array);

using namespace std;

static vector<char> parse_quals(const string& csv) {
    vector<char> out;
    stringstream ss(csv);
    string tok;
    while (getline(ss, tok, ',')) out.push_back((char)stoi(tok));
    return out;
}

static int run_tables(const char* dir) {
    Context<float> cf;
    Context<double> cd;
    string base(dir);
    {
        FILE* f = fopen((base + "/ctx_f32.bin").c_str(), "wb");
        fwrite(cf.ph2pr, sizeof(float), 128, f);
        fwrite(cf.matchToMatchProb, sizeof(float), ((MAX_QUAL + 1) * (MAX_QUAL + 2)) >> 1, f);
        fwrite(cf.jacobianLogTable, sizeof(float), JACOBIAN_LOG_TABLE_SIZE, f);
        float ic = cf.INITIAL_CONSTANT, lic = cf.LOG10_INITIAL_CONSTANT;
        fwrite(&ic, sizeof(float), 1, f);
        fwrite(&lic, sizeof(float), 1, f);
        fclose(f);
    }
    {
        FILE* f = fopen((base + "/ctx_f64.bin").c_str(), "wb");
        fwrite(cd.ph2pr, sizeof(double), 128, f);
        fwrite(cd.matchToMatchProb, sizeof(double), ((MAX_QUAL + 1) * (MAX_QUAL + 2)) >> 1, f);
        fwrite(cd.jacobianLogTable, sizeof(double), JACOBIAN_LOG_TABLE_SIZE, f);
        double ic = cd.INITIAL_CONSTANT, lic = cd.LOG10_INITIAL_CONSTANT;
        fwrite(&ic, sizeof(double), 1, f);
        fwrite(&lic, sizeof(double), 1, f);
        fclose(f);
    }
    fprintf(stderr, "tables written to %s\n", dir);
    return 0;
}

static int run_sw() {
    string line;
    while (getline(cin, line)) {
        if (line.empty()) continue;
        stringstream ss(line);
        string target, query;
        int match, mismatch, open_, ext, strategy;
        ss >> target >> query >> match >> mismatch >> open_ >> ext >> strategy;

        swParameters p;
        p.sc_match = match > 0 ? match : -match;
        p.sc_mismatch = mismatch < 0 ? mismatch : -mismatch;
        p.g_open = open_ > 0 ? open_ : -open_;
        p.g_ext = ext > 0 ? ext : -ext;

        string cigar_scalar, cigar_avx;
        int off_scalar = align_scalar(target.c_str(), (int)target.size(),
                                      query.c_str(), (int)query.size(), p,
                                      strategy, &cigar_scalar);
        int off_avx = -999999;
        if ((int)query.size() >= 8) {
            off_avx = align_avx(target.c_str(), (int)target.size(),
                                query.c_str(), (int)query.size(), p,
                                strategy, &cigar_avx);
        } else {
            cigar_avx = "-";
        }
        printf("%s %d %s %d\n", cigar_scalar.c_str(), off_scalar,
               cigar_avx.c_str(), off_avx);
    }
    return 0;
}

static int run_pairhmm() {
    string line;
    while (getline(cin, line)) {
        if (line.empty()) continue;
        stringstream ss(line);
        string hap, rd, qs, is, ds, cs;
        ss >> hap >> rd >> qs >> is >> ds >> cs;
        vector<char> q = parse_quals(qs), i = parse_quals(is),
                     d = parse_quals(ds), c = parse_quals(cs);

        readinfo read;
        read.rslen = (int)rd.size();
        read.rs = (char*)rd.c_str();
        read.q = q.data();
        read.i = i.data();
        read.d = d.data();
        read.c = c.data();
        read.irs = nullptr;

        double scores[5];
        const char* names[5] = {"scalarf", "scalard", "avxf", "avxd", "fast"};
        for (int k = 0; k < 5; k++) {
            vector<hapinfo> haps(1);
            haps[0].haplen = hap.size();
            haps[0].hap = (char*)hap.c_str();
            haps[0].index = 0;
            haps[0].position = 0;
            haps[0].score = 0.0;
            switch (k) {
                case 0: compute_prob_scalarf(read, haps); break;
                case 1: compute_prob_scalard(read, haps); break;
                case 2: compute_prob_avxf(read, haps); break;
                case 3: compute_prob_avxd(read, haps); break;
                case 4: compute_fast_prob_float(read, haps); break;
            }
            scores[k] = haps[0].score;
        }
        (void)names;
        printf("%a %a %a %a %a\n", scores[0], scores[1], scores[2], scores[3], scores[4]);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// CPU baseline benchmarks (BASELINE.md "first measurement task"): time the
// reference's production AVX2 kernels on synthetic 150 bp batches, one core.
// ---------------------------------------------------------------------------

#include <chrono>
#include <random>

static void rand_seq(std::mt19937& rng, char* dst, int n) {
    static const char B[4] = {'A', 'C', 'G', 'T'};
    for (int i = 0; i < n; i++) dst[i] = B[rng() & 3];
}

static int run_bench_sw(int n_pairs, int tlen, int qlen) {
    std::mt19937 rng(42);
    std::vector<std::string> ts(n_pairs), qs(n_pairs);
    for (int i = 0; i < n_pairs; i++) {
        ts[i].resize(tlen); qs[i].resize(qlen);
        rand_seq(rng, &ts[i][0], tlen);
        // query = mutated copy of target prefix for realistic traceback
        qs[i] = ts[i].substr(0, qlen);
        for (int k = 0; k < qlen / 20; k++) qs[i][rng() % qlen] = "ACGT"[rng() & 3];
    }
    swParameters p{25, -50, 110, 6};
    // warmup
    std::string cigar;
    align_avx(ts[0].c_str(), tlen, qs[0].c_str(), qlen, p, 1, &cigar);
    auto t0 = std::chrono::steady_clock::now();
    long long sink = 0;
    for (int i = 0; i < n_pairs; i++) {
        std::string cg;
        sink += align_avx(ts[i].c_str(), tlen, qs[i].c_str(), qlen, p, 1, &cg);
        sink += (long long)cg.size();
    }
    auto t1 = std::chrono::steady_clock::now();
    double sec = std::chrono::duration<double>(t1 - t0).count();
    double cells = double(n_pairs) * tlen * qlen;
    printf("{\"kernel\": \"sw_avx\", \"pairs\": %d, \"tlen\": %d, \"qlen\": %d, "
           "\"seconds\": %.4f, \"gcups\": %.3f, \"sink\": %lld}\n",
           n_pairs, tlen, qlen, sec, cells / sec / 1e9, sink);
    return 0;
}

static int run_bench_pairhmm(int n_reads, int n_haps, int rdlen, int haplen) {
    std::mt19937 rng(43);
    std::vector<std::string> rds(n_reads), hps(n_haps);
    std::vector<std::vector<char>> q(n_reads), ii(n_reads), dd(n_reads), cc(n_reads);
    for (int i = 0; i < n_reads; i++) {
        rds[i].resize(rdlen);
        rand_seq(rng, &rds[i][0], rdlen);
        q[i].assign(rdlen, 30); ii[i].assign(rdlen, 45);
        dd[i].assign(rdlen, 45); cc[i].assign(rdlen, 10);
    }
    for (int j = 0; j < n_haps; j++) {
        hps[j].resize(haplen);
        rand_seq(rng, &hps[j][0], haplen);
    }
    // warmup + timed loop: per read, all haps (JNI tiering without rescue)
    auto t0 = std::chrono::steady_clock::now();
    double sink = 0;
    for (int i = 0; i < n_reads; i++) {
        readinfo read;
        read.rslen = rdlen;
        read.rs = &rds[i][0];
        read.q = q[i].data(); read.i = ii[i].data();
        read.d = dd[i].data(); read.c = cc[i].data();
        read.irs = nullptr;
        std::vector<hapinfo> haps(n_haps);
        for (int j = 0; j < n_haps; j++) {
            haps[j].haplen = haplen; haps[j].hap = &hps[j][0];
            haps[j].index = j; haps[j].position = 0; haps[j].score = 0.0;
        }
        compute_prob_avxf(read, haps);
        for (int j = 0; j < n_haps; j++) sink += haps[j].score;
    }
    auto t1 = std::chrono::steady_clock::now();
    double sec = std::chrono::duration<double>(t1 - t0).count();
    double cells = double(n_reads) * n_haps * rdlen * haplen;
    printf("{\"kernel\": \"pairhmm_avxf\", \"reads\": %d, \"haps\": %d, "
           "\"rdlen\": %d, \"haplen\": %d, \"seconds\": %.4f, \"gcups\": %.3f, "
           "\"sink\": %g}\n", n_reads, n_haps, rdlen, haplen, sec,
           cells / sec / 1e9, sink);
    return 0;
}

int main(int argc, char** argv) {
    _MM_SET_FLUSH_ZERO_MODE(_MM_FLUSH_ZERO_ON);
    if (argc < 2) {
        fprintf(stderr, "usage: oracle tables <dir> | sw | pairhmm | "
                        "bench_sw [n t q] | bench_pairhmm [nr nh rl hl]\n");
        return 2;
    }
    if (!strcmp(argv[1], "tables")) return run_tables(argc > 2 ? argv[2] : ".");
    if (!strcmp(argv[1], "sw")) return run_sw();
    if (!strcmp(argv[1], "pairhmm")) return run_pairhmm();
    if (!strcmp(argv[1], "bench_sw"))
        return run_bench_sw(argc > 2 ? atoi(argv[2]) : 10000,
                            argc > 3 ? atoi(argv[3]) : 150,
                            argc > 4 ? atoi(argv[4]) : 150);
    if (!strcmp(argv[1], "bench_pairhmm"))
        return run_bench_pairhmm(argc > 2 ? atoi(argv[2]) : 200,
                                 argc > 3 ? atoi(argv[3]) : 8,
                                 argc > 4 ? atoi(argv[4]) : 150,
                                 argc > 5 ? atoi(argv[5]) : 400);
    fprintf(stderr, "unknown mode %s\n", argv[1]);
    return 2;
}
