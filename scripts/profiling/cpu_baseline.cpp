// Measured CPU baseline for the headline kernel bench: the same
// count+join workload bench.py's run_kernel_bench times on the device,
// implemented as an efficient multicore C++ count+merge so
// `vs_baseline` divides by a number MEASURED on the host instead of a
// literature anchor. chip_smoke.py also holds count_join_stats to its
// statistics bit for bit.
//
// Workload (identical to bench.py): E k-mer instances (u64 value +
// sample id), N banks. Compute per-(kmer, sample) counts, apply the
// abundance filter, and accumulate the default cross-sample pair
// channels (co-presence, sum C_a, sum C_b, sum min) over equal-k-mer
// groups -- the reference's SimkaCount + SimkaMerge +
// SimkaCountProcessorSimple hot path
// (/root/reference/src/SimkaMerge.cpp:1189-1325), restructured the
// way a performance-minded CPU implementation would: hash-range
// partitions (the reference's repartition), per-partition sort of
// packed (kmer, sid) keys (DSK's sort-based counting), run-length
// counts, and in-cache pair accumulation -- parallelized over
// partitions with one thread per core.
//
// Build: g++ -O3 -march=native -pthread cpu_baseline.cpp -o cpu_baseline
// Run:   ./cpu_baseline [E_log2=24] [n_banks=8] [iters=3] [in_file]
// Prints one JSON line {"cpu_kmers_per_sec": ..., "threads": ...}.
// With in_file (raw little-endian: i64 E, i32 N, E x u64 vals,
// E x u8 sid) it also dumps the full statistics so
// tests/test_cpu_baseline.py can verify this baseline computes
// exactly what ops.countjoin computes (no undercounting shortcut).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

struct Acc {
  // upper-triangle pair sums, N*N flattened
  std::vector<int64_t> shared_distinct, ab, ba, bray;
  int64_t nb_distinct = 0, nb_shared = 0;
  explicit Acc(int n)
      : shared_distinct(n * n, 0), ab(n * n, 0), ba(n * n, 0),
        bray(n * n, 0) {}
  void add(const Acc &o) {
    for (size_t i = 0; i < ab.size(); i++) {
      shared_distinct[i] += o.shared_distinct[i];
      ab[i] += o.ab[i];
      ba[i] += o.ba[i];
      bray[i] += o.bray[i];
    }
    nb_distinct += o.nb_distinct;
    nb_shared += o.nb_shared;
  }
};

int main(int argc, char **argv) {
  const int elog = argc > 1 ? atoi(argv[1]) : 24;
  int N = argc > 2 ? atoi(argv[2]) : 8;
  const int iters = argc > 3 ? atoi(argv[3]) : 3;
  const char *in_file = argc > 4 ? argv[4] : nullptr;
  size_t E = 1ull << elog;
  const int amin = 1;

  std::vector<uint64_t> vals;
  std::vector<uint8_t> sid;
  if (in_file) {
    FILE *f = fopen(in_file, "rb");
    if (!f) { perror("in_file"); return 1; }
    int64_t e64; int32_t n32;
    if (fread(&e64, 8, 1, f) != 1 || fread(&n32, 4, 1, f) != 1) return 1;
    E = (size_t)e64; N = n32;
    vals.resize(E); sid.resize(E);
    if (fread(vals.data(), 8, E, f) != E) return 1;
    if (fread(sid.data(), 1, E, f) != E) return 1;
    fclose(f);
  } else {
    // synthetic instance stream (same shape as bench.py's)
    const uint64_t space = E / 2;  // ~2x coverage, as in bench.py
    vals.resize(E); sid.resize(E);
    std::mt19937_64 rng(0);
    for (size_t i = 0; i < E; i++) {
      vals[i] = rng() % space;
      sid[i] = (uint8_t)(rng() % N);
    }
  }
  int sbits = 1;
  while ((1 << sbits) < N) sbits++;

  unsigned T = std::thread::hardware_concurrency();
  if (T == 0) T = 1;
  const int P = T * 4;  // partitions (hash ranges)

  double best = 1e30;
  int64_t sink = 0;
  for (int it = 0; it < iters; it++) {
    auto t0 = std::chrono::steady_clock::now();

    // ---- phase 1: partition by k-mer hash range (the reference's
    // repartition; one pass, per-thread local buffers) ----
    std::vector<std::vector<std::vector<uint64_t>>> parts(
        T, std::vector<std::vector<uint64_t>>(P));
    {
      std::vector<std::thread> th;
      size_t chunk = (E + T - 1) / T;
      for (unsigned t = 0; t < T; t++) {
        th.emplace_back([&, t] {
          size_t lo = t * chunk, hi = std::min(E, lo + chunk);
          auto &my = parts[t];
          for (auto &v : my) v.reserve((hi - lo) / P + 16);
          for (size_t i = lo; i < hi; i++) {
            uint64_t key = (vals[i] << sbits) | sid[i];
            my[(vals[i] * 0x9E3779B97F4A7C15ull) >> 56 & (P - 1)]
                .push_back(key);
          }
        });
      }
      for (auto &x : th) x.join();
    }

    // ---- phase 2: per-partition sort + count + merge + pair
    // accumulation (parallel over partitions) ----
    std::vector<Acc> accs(T, Acc(N));
    std::atomic<int> next(0);
    std::vector<std::thread> th;
    for (unsigned t = 0; t < T; t++) {
      th.emplace_back([&, t] {
        std::vector<uint64_t> buf;
        auto &acc = accs[t];
        std::vector<uint32_t> cnt;
        std::vector<uint8_t> sids;
        for (;;) {
          int p = next.fetch_add(1);
          if (p >= P) break;
          buf.clear();
          for (unsigned u = 0; u < T; u++)
            buf.insert(buf.end(), parts[u][p].begin(),
                       parts[u][p].end());
          std::sort(buf.begin(), buf.end());
          // run-length -> (kmer, sid, count) rows; then group by
          // kmer and accumulate every a<b pair (rows are
          // sid-ascending within a k-mer)
          size_t i = 0, n = buf.size();
          cnt.clear();
          sids.clear();
          uint64_t cur_kmer = ~0ull;
          auto flush = [&] {
            size_t m = cnt.size();
            if (!m) return;
            acc.nb_distinct++;
            if (m > 1) acc.nb_shared++;
            for (size_t a = 0; a < m; a++)
              for (size_t b = a + 1; b < m; b++) {
                int cell = sids[a] * N + sids[b];
                acc.shared_distinct[cell]++;
                acc.ab[cell] += cnt[a];
                acc.ba[cell] += cnt[b];
                acc.bray[cell] += std::min(cnt[a], cnt[b]);
              }
            cnt.clear();
            sids.clear();
          };
          while (i < n) {
            uint64_t key = buf[i];
            size_t j = i;
            while (j < n && buf[j] == key) j++;
            uint32_t c = (uint32_t)(j - i);
            uint64_t kmer = key >> sbits;
            if (kmer != cur_kmer) {
              flush();
              cur_kmer = kmer;
            }
            if (c >= (uint32_t)amin) {
              cnt.push_back(c);
              sids.push_back((uint8_t)(key & ((1 << sbits) - 1)));
            }
            i = j;
          }
          flush();
        }
      });
    }
    for (auto &x : th) x.join();
    Acc total(N);
    for (auto &a : accs) total.add(a);
    sink += total.nb_distinct + total.ab[1] + total.bray[1];

    double dt = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0)
                    .count();
    if (dt < best) best = dt;

    if (in_file && it == iters - 1) {
      auto mat = [&](const char *name, const std::vector<int64_t> &m) {
        printf("\"%s\": [", name);
        for (int i = 0; i < N * N; i++)
          printf("%s%lld", i ? "," : "", (long long)m[i]);
        printf("], ");
      };
      printf("{");
      mat("shared_distinct", total.shared_distinct);
      mat("shared_kmers_ab", total.ab);
      mat("shared_kmers_ba", total.ba);
      mat("bray_numerator", total.bray);
      printf("\"nb_distinct\": %lld, \"nb_shared\": %lld}\n",
             (long long)total.nb_distinct, (long long)total.nb_shared);
    }
  }

  printf("{\"cpu_kmers_per_sec\": %.1f, \"threads\": %u, "
         "\"E\": %zu, \"checksum\": %lld}\n",
         (double)E / best, T, E, (long long)sink);
  return 0;
}
