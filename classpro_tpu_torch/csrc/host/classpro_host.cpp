// Host data plane: sequence context, wall detection, reliable-interval
// selection, FASTK profile decoding, and a model's binomial-tail tables.
//
// This is a from-scratch C++ implementation of the wall stage semantics
// established (and golden-verified byte-identical against the reference
// binary) by the Python oracle in classpro_tpu/exact/.  Reference
// citations refer to the reference ClassPro sources (src/) for
// behavioral parity:
//   context:   context.c:8-108
//   walls:     wall.c:246-958
//   intervals: wall.c:960-1051
//   decode:    libfastk.c:1464-1534
//
// The port's own copy of the repository's csrc/classpro_host.cpp (the
// JAX package builds that one), with cp_build_btg, cp_exact_rel_batch,
// cp_pack_chunk, cp_expand_rows, cp_demote_reconcile, the wall stage
// that decodes each read's profile in its worker (cp_wall_stage_fastk),
// the streaming FASTX reader (cp_fx_*) and the .class composer
// (cp_class_compose) added, every threaded entry
// on one kept worker pool (pool::Pool), and the entries that nothing
// here calls (cp_wall_stage_batch, cp_unrel_batch, cp_expand_batch, the
// whole-file cp_gzip_inflate and cp_fastx_parse) left out.  Exposed via
// a C ABI for ctypes (classpro_tpu_torch/native.py).
// All floating point follows C double semantics (this is the same libm
// the reference links, so values are bit-identical to the oracle).

#include <algorithm>
#include <atomic>
#include <zlib.h>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <deque>
#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>
#if defined(__AVX2__)
#include <immintrin.h>
#endif
#include <condition_variable>
#include <functional>
#include <mutex>
#include <pthread.h>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------
// The host plane's worker pool: every threaded entry runs its rows here.
// Worker threads are kept for the process: a job runs on the calling
// thread and T - 1 of them, so a call pays a wake-up, not threads' start
// and join (on the 8-core host of an H100 machine, eight workers started
// per call took an expansion 1.5 ms against 0.58 ms on one), and a
// worker's thread_local workspaces stay warm from one call to the next.
// A job is closed once the caller's share returns (every row is taken
// by then): the caller waits for the helpers inside it, not for helpers
// that had not woken yet, which skip it, so a short job does not wait
// for the slowest wake-up.  One job at a time; the threads are never
// joined, and a forked child starts a pool of its own (the parent's
// threads do not exist there).
// ---------------------------------------------------------------------

namespace pool {

// min(threads, hardware, items / grain rounded up), at least 1
static int worker_count(int threads, int items, int grain = 1) {
  int T = threads;
  int hw = (int)std::thread::hardware_concurrency();
  if (hw > 0 && T > hw) T = hw;
  const int most = (items + grain - 1) / grain;
  if (T > most) T = most;
  return T < 1 ? 1 : T;
}

class Pool {
 public:
  static Pool& get() {
    static std::once_flag once;
    std::call_once(once, [] {
      g_pool = new Pool();
      pthread_atfork(nullptr, nullptr, [] { g_pool = new Pool(); });
    });
    return *g_pool;
  }

  void run(int T, const std::function<void()>& job) {
    std::lock_guard<std::mutex> one(run_mu_);
    {
      std::lock_guard<std::mutex> lk(mu_);
      while ((int)n_threads_ < T - 1) {
        const int idx = n_threads_++;
        new std::thread([this, idx] { loop(idx); });   // lives on
      }
      job_ = &job;
      helpers_ = T - 1;
      gen_++;
    }
    wake_.notify_all();
    job();
    std::unique_lock<std::mutex> lk(mu_);
    job_ = nullptr;
    done_.wait(lk, [this] { return active_ == 0; });
  }

 private:
  static Pool* g_pool;

  void loop(int idx) {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      wake_.wait(lk, [&] { return gen_ != seen; });
      seen = gen_;
      if (idx >= helpers_ || job_ == nullptr) continue;
      const std::function<void()>* job = job_;
      active_++;
      lk.unlock();
      (*job)();
      lk.lock();
      if (--active_ == 0) done_.notify_one();
    }
  }

  std::mutex run_mu_, mu_;
  std::condition_variable wake_, done_;
  const std::function<void()>* job_ = nullptr;
  uint64_t gen_ = 0;
  int n_threads_ = 0, helpers_ = 0, active_ = 0;
};
Pool* Pool::g_pool = nullptr;

// run body(t) for t in [0, items) on T workers (the caller one of them),
// rows off an atomic counter; each worker is worth at least `grain` rows
// (a short row is not worth a helper's wake-up)
template <class F>
static void parallel_rows(int items, int threads, F body, int grain = 1) {
  const int T = worker_count(threads, items, grain);
  std::atomic<int> next(0);
  const std::function<void()> worker = [&]() {
    for (;;) {
      int t = next.fetch_add(1);
      if (t >= items) return;
      body(t);
    }
  };
  if (T == 1) worker();
  else Pool::get().run(T, worker);
}

}  // namespace pool

namespace {

constexpr int MAX_KMER_CNT = 32767;
constexpr double NEG_INF = -INFINITY;

// coarse section timers, enabled by env CP_PROF (stderr report per call)
static inline long long now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (long long)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

// ---------------------------------------------------------------------
// numerics (semantics of prob.c / bessel.c / util.c; fresh implementation)
// ---------------------------------------------------------------------

static double g_logfact[MAX_KMER_CNT + 1];

static void init_logfact() {
  static bool done = false;
  if (done) return;
  g_logfact[0] = 0.0;
  for (int n = 1; n <= MAX_KMER_CNT; n++)
    g_logfact[n] = g_logfact[n - 1] + std::log((double)n);
  done = true;
}

static inline int clamp_cnt(int n) { return n > MAX_KMER_CNT ? MAX_KMER_CNT : n; }

static double nr_bessi0(double x) {
  double ax = std::fabs(x);
  if (ax < 3.75) {
    double y = x / 3.75;
    y *= y;
    return 1.0 + y * (3.5156229 + y * (3.0899424 + y * (1.2067492 +
           y * (0.2659732 + y * (0.360768e-1 + y * 0.45813e-2)))));
  }
  double y = 3.75 / ax;
  return (std::exp(ax) / std::sqrt(ax)) * (0.39894228 + y * (0.1328592e-1 +
         y * (0.225319e-2 + y * (-0.157565e-2 + y * (0.916281e-2 +
         y * (-0.2057706e-1 + y * (0.2635537e-1 + y * (-0.1647633e-1 +
         y * 0.392377e-2))))))));
}

static double nr_bessi1(double x) {
  double ax = std::fabs(x), ans;
  if (ax < 3.75) {
    double y = x / 3.75;
    y *= y;
    ans = ax * (0.5 + y * (0.87890594 + y * (0.51498869 + y * (0.15084934 +
          y * (0.2658733e-1 + y * (0.301532e-2 + y * 0.32411e-3))))));
  } else {
    double y = 3.75 / ax;
    ans = 0.2282967e-1 + y * (-0.2895312e-1 + y * (0.1787654e-1 -
          y * 0.420059e-2));
    ans = 0.39894228 + y * (-0.3988024e-1 + y * (-0.362018e-2 +
          y * (0.163801e-2 + y * (-0.1031555e-1 + y * ans))));
    ans *= std::exp(ax) / std::sqrt(ax);
  }
  return x < 0.0 ? -ans : ans;
}

static double nr_bessi(int n, double x) {
  if (n == 0) return nr_bessi0(x);
  if (n == 1) return nr_bessi1(x);
  if (x == 0.0) return 0.0;
  const double tox = 2.0 / std::fabs(x);
  double bip = 0.0, ans = 0.0, bi = 1.0;
  for (int j = 2 * (n + (int)std::sqrt(40.0 * n)); j > 0; j--) {
    double bim = bip + j * tox * bi;
    bip = bi;
    bi = bim;
    if (std::fabs(bi) > 1.0e10) {
      ans *= 1.0e-10;
      bi *= 1.0e-10;
      bip *= 1.0e-10;
    }
    if (j == n) ans = bip;
  }
  ans *= nr_bessi0(x) / bi;
  return (x < 0.0 && (n & 1)) ? -ans : ans;
}

static inline double logp_skellam(int k, double lam) {
  return -2.0 * lam + std::log(nr_bessi(std::abs(k), 2.0 * lam));
}

static inline double logp_binom_pre(int k, int n, double lpe, double l1mpe) {
  return g_logfact[n] - g_logfact[k] - g_logfact[n - k] + k * lpe +
         (n - k) * l1mpe;
}

// one-sided binomial tail with early-exit approximation (prob.c:76-112
// semantics: loop order determines rounding)
static double binom_tail(int k, int n, double pe, bool exact) {
  k = clamp_cnt(k);
  n = clamp_cnt(n);
  const double lpe = std::log(pe), l1mpe = std::log(1 - pe);
  const double mean = n * pe;
  double p, p_first, p_curr;
  if ((double)k >= mean) {
    p = p_first = std::exp(logp_binom_pre(k, n, lpe, l1mpe));
    for (int x = k + 1; x <= n; x++) {
      p += p_curr = std::exp(logp_binom_pre(x, n, lpe, l1mpe));
      if (!exact && 10 * p_curr < p_first) break;
    }
    return p;
  }
  p = p_first = (k == 0) ? 0.0 : std::exp(logp_binom_pre(k - 1, n, lpe, l1mpe));
  for (int x = k - 2; x >= 0; x--) {
    p += p_curr = std::exp(logp_binom_pre(x, n, lpe, l1mpe));
    if (!exact && 10 * p_curr < p_first) break;
  }
  return 1 - p;
}

enum { SELF = 0, OTHERS = 1 };
enum { DROP = 0, GAIN = 1 };
enum { TINIT = 0, TFINAL = 1 };

static inline double p_errorin(int e, double erate, int cout, int cin) {
  return binom_tail(e == SELF ? cin : cout - cin, cout, erate, false);
}

// ---------------------------------------------------------------------
// model parameters (mirror of estimation.GlobalModel + Defaults)
// ---------------------------------------------------------------------

struct Model {
  int K;
  int cmax;        // GLOBAL_COV[REPEAT]
  int cov_h;       // GLOBAL_COV[HAPLO]
  int read_len;
  int max_n_hc;
  int min_cnt_change;
  int max_cnt_change;
  double pe_thres[2][2];   // [ThresT][Etype]
  double thres_diff_eo;
  double thres_diff_rel;
  double hc_erate;
  int lmax[3];
  int lmaxp1;              // stride of pe rows
  const double* pe;        // [3][lmaxp1]
  const int16_t* cthres;   // [3][lmaxp1][cmax][2][2]
  double logpthres_final_self;
  // optional bit-exact binom_test_g tail tables (tables.py _btg_row):
  // btg[(ridx*n_cap + n)*n_cap + k]; erates[ridx] guards value identity
  const double* btg = nullptr;
  const double* erates = nullptr;
  const int32_t* pe_idx = nullptr;   // [3][lmaxp1] -> erate index
  int hc_idx = -1;
  int n_cap = 0;
};

// tail lookup with exact fallback (p_errorin semantics)
static inline double p_errorin_tab(const Model& M, int e, int ridx,
                                   double erate, int cout, int cin) {
  int k = e == SELF ? cin : cout - cin;
  if (M.btg && ridx >= 0 && M.erates[ridx] == erate && cout >= 1 &&
      cout < M.n_cap && k >= 0 && k <= cout)
    return M.btg[((size_t)ridx * M.n_cap + cout) * M.n_cap + k];
  return p_errorin(e, erate, cout, cin);
}

static inline int16_t cthres_at(const Model& M, int t, int l, int cout,
                                int s, int e) {
  return M.cthres[(((t * M.lmaxp1 + l) * M.cmax + cout) * 2 + s) * 2 + e];
}

static inline bool cthres_ng(int e, int cin, int ct) {
  return e == SELF ? cin >= ct : cin < ct;
}

// ---------------------------------------------------------------------
// sequence context (same recurrences as classpro_tpu/context.py)
// ---------------------------------------------------------------------

static void seq_context(const char* s, int rlen, uint8_t* lctx, uint8_t* rctx) {
  // lctx/rctx are (rlen, 3) row-major, zero-initialized by caller
  auto L = [&](int i, int t) -> uint8_t& { return lctx[i * 3 + t]; };
  auto R = [&](int i, int t) -> uint8_t& { return rctx[i * 3 + t]; };
  L(0, 0) = 1;
  const int rlenm1 = rlen - 1;
  int in_ds = 0, in_ts = 0;
  for (int i = 1; i < rlen; i++) {
    const int in_hp = s[i - 1] == s[i];
    in_ds = in_ts = 0;
    if (in_hp) {
      L(i, 0) = (uint8_t)std::min<int>(L(i - 1, 0) + 1, 127);
      L(i, 1) = R(i - 1, 1) = 0;
    } else {
      L(i, 0) = 1;
      L(i, 1) = R(i - 1, 1) = 1;
      for (int j = i - L(i - 1, 0), n = 0; j < i; j++, n++)
        R(j, 0) = L(i - 1 - n, 0);
      if (i >= 3 && s[i - 3] == s[i - 1] && s[i - 2] == s[i]) {
        L(i, 1) = (uint8_t)std::min<int>(L(i - 2, 1) + 1, 127);
        in_ds = 1;
      }
    }
    if (!in_ds) {
      int l = i - 1;
      while (L(l, 1) > 1) l--;
      if (l < i - 1)
        for (int j = l - 1, n = 0; j < i; j++, n++)
          R(j - 1, 1) = L(i - 1 - n, 1);
    }
    if (i >= 2) {
      if (in_hp && s[i - 2] == s[i - 1])
        L(i, 2) = R(i - 2, 2) = 0;
      else if (i >= 5 && s[i - 5] == s[i - 2] && s[i - 4] == s[i - 1] &&
               s[i - 3] == s[i]) {
        L(i, 2) = (uint8_t)std::min<int>(L(i - 3, 2) + 1, 127);
        in_ts = 1;
      } else
        L(i, 2) = R(i - 1, 2) = R(i - 2, 2) = 1;
      if (!in_ts) {
        int l = i - 1;
        while (L(l, 2) > 1) l--;
        if (l < i - 1)
          for (int j = l - 2, n = 0; j < i; j++, n++)
            R(j - 2, 2) = L(i - 1 - n, 2);
      }
    }
  }
  for (int j = rlen - L(rlenm1, 0), n = 0; j < rlen; j++, n++)
    R(j, 0) = L(rlenm1 - n, 0);
  if (in_ds) {
    int l = rlenm1;
    while (L(l, 1) > 1) l--;
    if (l < rlenm1)
      for (int j = l - 1, n = 0; j < rlen; j++, n++)
        R(j - 1, 1) = L(rlenm1 - n, 1);
  }
  if (in_ts) {
    int l = rlenm1;
    while (L(l, 2) > 1) l--;
    if (l < rlenm1)
      for (int j = l - 2, n = 0; j < rlen; j++, n++)
        R(j - 2, 2) = L(rlenm1 - n, 2);
  }
  R(rlenm1, 1) = R(rlenm1, 2) = R(rlen - 2, 2) = 0;
}

// On-demand context: the wall walk consults run lengths only around
// candidate wall positions (~1.5% of positions pass the prescreen), so
// instead of precomputing full (rlen, 3) tables, each query runs a
// bounded local scan reproducing seq_context's value exactly:
//
// * lctx planes follow the (capped) backward recurrences of the forward
//   fill above;
// * rctx planes 1/2 follow the mirrored forward recurrences (the
//   reference's backfills walk whole runs, so the mirror equals the
//   forward unit count even past the 127 cap);
// * rctx plane 0 reproduces the reference's artifact that only the last
//   lctx(b,0) <= 127 positions of a homopolymer run are backfilled
//   (mirroring the CAPPED lctx sequence; deeper positions keep 0).
//
// Exhaustively validated equal to seq_context (tests/test_tpu_engine.py).
struct CtxOnDemand {
  const char* s;
  int rlen;

  int l(int i, int t) const {
    if (t == 0) {
      int n = 1, k = i;
      while (k >= 1 && s[k - 1] == s[k] && n < 127) { n++; k--; }
      return n;
    }
    if (t == 1) {
      if (i < 1) return 0;
      if (s[i - 1] == s[i]) return 0;
      int f = 0, k = i;
      while (k >= 3 && s[k - 3] == s[k - 1] && s[k - 2] == s[k]) {
        if (++f >= 127) return 127;
        k -= 2;
        if (k < 1 || (s[k - 1] == s[k])) return f;   // base L=0
      }
      return f + 1;
    }
    if (i < 2) return 0;
    if (s[i - 1] == s[i] && s[i - 2] == s[i - 1]) return 0;
    int f = 0, k = i;
    while (k >= 5 && s[k - 5] == s[k - 2] && s[k - 4] == s[k - 1] &&
           s[k - 3] == s[k]) {
      if (++f >= 127) return 127;
      k -= 3;
      if (k < 2 || (s[k - 1] == s[k] && s[k - 2] == s[k - 1])) return f;
    }
    return f + 1;
  }

  int r(int j, int t) const {
    if (t == 0) {
      int m = 0;
      while (j + m + 1 < rlen && s[j + m] == s[j + m + 1] && m < 127) m++;
      if (m >= 127) return 0;              // deeper than the backfill window
      int back = 0;
      while (j - back - 1 >= 0 && s[j - back - 1] == s[j - back] &&
             back < 253) back++;
      int runlen = m + 1 + back;
      if (runlen <= 127) return m + 1;     // plain mirror
      int v = m + runlen - 126;            // mirror of the capped L values
      return v > 127 ? 127 : v;
    }
    if (t == 1) {
      if (j >= rlen - 1) return 0;
      if (s[j] == s[j + 1]) return 0;
      int f = 0, k = j;
      while (k + 3 < rlen && s[k + 3] == s[k + 1] && s[k + 2] == s[k]) {
        if (++f >= 127) return 127;
        k += 2;
        if (k + 1 >= rlen || s[k] == s[k + 1]) return f;
      }
      return f + 1;
    }
    if (j >= rlen - 2) return 0;
    if (s[j] == s[j + 1] && s[j + 2] == s[j + 1]) return 0;
    int f = 0, k = j;
    while (k + 5 < rlen && s[k + 5] == s[k + 2] && s[k + 4] == s[k + 1] &&
           s[k + 3] == s[k]) {
      if (++f >= 127) return 127;
      k += 3;
      if (k >= rlen - 2 || (s[k] == s[k + 1] && s[k + 2] == s[k + 1]))
        return f;
    }
    return f + 1;
  }
};

// ---------------------------------------------------------------------
// wall detection (mirror of classpro_tpu/exact/wall.py WallFinder)
// ---------------------------------------------------------------------

struct EIntvl { int b, e; double pe; };

struct Workspace {
  std::vector<uint8_t> wall;
  std::vector<double> perror;   // (plen+1) x 2 x 2, generation-stamped
  std::vector<uint32_t> pstamp; // entry valid iff pstamp[k] == pgen
  uint32_t pgen = 0;
  std::vector<EIntvl> eintvl, ointvl;
  std::vector<uint8_t> cand;
  std::vector<int> cand_idx, bnd;
};

struct OutIntvl {
  int32_t b, e, cb, ce, ccb, cce, is_rel, pad;
  double pe, pe_o_b, pe_o_e;
};

class WallWalk {
 public:
  WallWalk(const Model& M, const uint16_t* prof, int plen,
           const CtxOnDemand& cd, Workspace& ws)
      : M_(M), prof_(prof), plen_(plen), cd_(cd), ws_(ws) {}

  // ctx accessors: DROP -> lctx[i+K-2], GAIN -> rctx[i]
  inline int ctx(int w, int i, int t) const {
    return w == DROP ? cd_.l(i + M_.K - 2, t) : cd_.r(i, t);
  }

  // generation-stamped lazy table: an entry not written during THIS
  // read reads as NEG_INF (replaces a per-read O(plen) memset)
  inline double perr(int i, int e, int w) const {
    size_t k = ((size_t)i * 2 + e) * 2 + w;
    return ws_.pstamp[k] == ws_.pgen ? ws_.perror[k] : NEG_INF;
  }

  inline double logp_trans(int b, int e, int cb, int ce, int cov) const {
    return logp_skellam(ce - cb, (double)cov * std::abs(e - b) / M_.read_len);
  }

  inline double logp_diff_pair(int i, int j) const {
    int nd = (int)prof_[i - 1] - prof_[i];
    int ng = (int)prof_[j] - prof_[j - 1];
    int cov = std::max<int>(prof_[i - 1], prof_[j]);
    return logp_trans(i, j, nd, ng, cov);
  }

  inline void update_perror(int i, int e, int w, int cout, int cin,
                            double erate, int ridx) {
    size_t k = ((size_t)i * 2 + e) * 2 + w;
    if (ws_.pstamp[k] != ws_.pgen) {
      ws_.perror[k] = p_errorin_tab(M_, e, ridx, erate, cout, cin);
      ws_.pstamp[k] = ws_.pgen;
    }
  }

  bool find_gain(int i, int cout, int cin, int e, int t, int l, double erate,
                 int ridx, EIntvl& out) {
    const int ipk = i + M_.K - 1, ulen = t + 1;
    int max_j = -1;
    double max_pe = NEG_INF, pe;
    int m = ulen * l, n = 0;
    while (true) {
      int idx = i + ulen * (n + 1);
      if (idx >= plen_ || ctx(DROP, idx, t) != m + n + 1) break;
      n++;
    }
    int j = ipk + n - m;
    if (j <= i) return false;
    if (j >= plen_) {
      j = plen_;
      pe = perr(i, e, DROP) * perr(i, e, DROP);
    } else {
      int cin_j = prof_[j - 1], cout_j = prof_[j];
      pe = NEG_INF;
      if (cin_j <= cout_j &&
          !(cout_j < M_.cmax &&
            cthres_ng(e, cin_j, cthres_at(M_, t, l, cout_j, TFINAL, e))) &&
          (e == SELF || logp_diff_pair(i, j) >= M_.thres_diff_eo)) {
        update_perror(j, e, GAIN, cout_j, cin_j, erate, ridx);
        pe = perr(i, e, DROP) * perr(j, e, GAIN);
      }
    }
    if (max_pe < pe) { max_j = j; max_pe = pe; }
    for (int nn = 0; nn <= M_.max_n_hc; nn++) {
      j = ipk + nn;
      if (j >= plen_) break;
      int cin_j = prof_[j - 1], cout_j = prof_[j];
      if (!(cin_j <= cout_j)) continue;
      if ((cout < M_.cmax &&
           cthres_ng(e, cin, cthres_at(M_, 0, 1, cout, TFINAL, e))) ||
          (cout_j < M_.cmax &&
           cthres_ng(e, cin_j, cthres_at(M_, 0, 1, cout_j, TFINAL, e))))
        continue;
      if (e == OTHERS && logp_diff_pair(i, j) < M_.thres_diff_eo) continue;
      double pe_i = p_errorin_tab(M_, e, M_.hc_idx, M_.hc_erate, cout, cin);
      double pe_j = p_errorin_tab(M_, e, M_.hc_idx, M_.hc_erate, cout_j, cin_j);
      pe = pe_i * pe_j;
      if (max_pe < pe) { max_j = j; max_pe = pe; }
    }
    if (max_j == -1) return false;
    out = {i, max_j, max_pe};
    return true;
  }

  bool find_drop(int i, int cout, int cin, int e, int t, int l, double erate,
                 int ridx, EIntvl& out) {
    const int imk = i - M_.K + 1, ulen = t + 1;
    int max_j = -1;
    double max_pe = NEG_INF, pe;
    int m = ulen * l, n = 0;
    while (true) {
      int idx = i - ulen * (n + 1);
      if (idx <= 0 || ctx(GAIN, idx, t) != m + n + 1) break;
      n++;
    }
    int j = imk - n + m;
    if (j >= i) return false;
    if (j <= 0) {
      j = 0;
      pe = perr(i, e, GAIN) * perr(i, e, GAIN);
    } else {
      int cout_j = prof_[j - 1], cin_j = prof_[j];
      pe = NEG_INF;
      if (cin_j <= cout_j &&
          !(cout_j < M_.cmax &&
            cthres_ng(e, cin_j, cthres_at(M_, t, l, cout_j, TFINAL, e))) &&
          (e == SELF || logp_diff_pair(j, i) >= M_.thres_diff_eo)) {
        update_perror(j, e, DROP, cout_j, cin_j, erate, ridx);
        pe = perr(j, e, DROP) * perr(i, e, GAIN);
      }
    }
    if (max_pe < pe) { max_j = j; max_pe = pe; }
    for (int nn = 0; nn <= M_.max_n_hc; nn++) {
      j = imk - nn;
      if (j <= 0) break;
      int cout_j = prof_[j - 1], cin_j = prof_[j];
      if (!(cin_j <= cout_j)) continue;
      if ((cout < M_.cmax &&
           cthres_ng(e, cin, cthres_at(M_, 0, 1, cout, TFINAL, e))) ||
          (cout_j < M_.cmax &&
           cthres_ng(e, cin_j, cthres_at(M_, 0, 1, cout_j, TFINAL, e))))
        continue;
      if (e == OTHERS && logp_diff_pair(j, i) < M_.thres_diff_eo) continue;
      double pe_i = p_errorin_tab(M_, e, M_.hc_idx, M_.hc_erate, cout, cin);
      double pe_j = p_errorin_tab(M_, e, M_.hc_idx, M_.hc_erate, cout_j, cin_j);
      pe = pe_i * pe_j;
      if (max_pe < pe) { max_j = j; max_pe = pe; }
    }
    if (max_j == -1) return false;
    out = {max_j, i, max_pe};
    return true;
  }

  // wall bitmask bits
  static constexpr uint8_t W_BY[2] = {0x01, 0x10};
  static constexpr uint8_t P_BY[2] = {0x02, 0x20};
  static constexpr uint8_t P_MULT = 0x40;
  static constexpr uint8_t ERRB = 0x80;

  int run(OutIntvl* out, int out_cap) {
    auto& wall = ws_.wall;
    auto& eintvl = ws_.eintvl;
    auto& ointvl = ws_.ointvl;
    wall.assign(plen_ + 1, 0);
    size_t need = (size_t)(plen_ + 1) * 4;
    if (ws_.perror.size() < need) {
      ws_.perror.resize(need);
      ws_.pstamp.resize(need, 0);
    }
    if (++ws_.pgen == 0) {
      std::fill(ws_.pstamp.begin(), ws_.pstamp.end(), 0);
      ws_.pgen = 1;
    }
    eintvl.clear();
    ointvl.clear();

    // vectorizable candidate prescreen: walls are rare (~1.5% of
    // positions pass), so the wall-test work below runs over a compacted
    // candidate index list instead of every position.  Single fused
    // pass: 16 u16 lanes -> movemask -> direct index extraction (no
    // intermediate flag array, no second scan).
    auto& cidx = ws_.cand_idx;
    cidx.clear();
#if defined(__AVX2__)
    {
      const __m256i cmaxv = _mm256_set1_epi16((short)M_.cmax);
      const __m256i mccm1 =
          _mm256_set1_epi16((short)(M_.min_cnt_change - 1));
      int i = 1;
      for (; i + 16 <= plen_; i += 16) {
        __m256i a = _mm256_loadu_si256((const __m256i*)(prof_ + i - 1));
        __m256i b = _mm256_loadu_si256((const __m256i*)(prof_ + i));
        __m256i mn = _mm256_min_epu16(a, b);
        __m256i mx = _mm256_max_epu16(a, b);
        // counts are <= 32767 so signed 16-bit compares are exact
        __m256i ok_lo = _mm256_cmpgt_epi16(cmaxv, mn);
        __m256i ok_ch =
            _mm256_cmpgt_epi16(_mm256_sub_epi16(mx, mn), mccm1);
        __m256i ok = _mm256_and_si256(ok_lo, ok_ch);
        uint32_t mask = (uint32_t)_mm256_movemask_epi8(
            _mm256_packs_epi16(ok, _mm256_setzero_si256()));
        // packs interleaves 128-bit halves: low 8 flags in bits 0..7,
        // high 8 flags in bits 16..23
        uint32_t m16 = (mask & 0xffu) | ((mask >> 8) & 0xff00u);
        while (m16) {
          int b2 = __builtin_ctz(m16);
          cidx.push_back(i + b2);
          m16 &= m16 - 1;
        }
      }
      for (; i < plen_; i++) {
        uint16_t a = prof_[i - 1], b = prof_[i];
        uint16_t mn = a < b ? a : b;
        uint16_t mx = a < b ? b : a;
        if ((mn < (uint16_t)M_.cmax) &
            ((uint16_t)(mx - mn) >= (uint16_t)M_.min_cnt_change))
          cidx.push_back(i);
      }
    }
#else
    {
      const uint16_t cmax16 = (uint16_t)M_.cmax;
      const uint16_t mcc16 = (uint16_t)M_.min_cnt_change;
      for (int i = 1; i < plen_; i++) {
        uint16_t a = prof_[i - 1], b = prof_[i];
        uint16_t mn = a < b ? a : b;
        uint16_t mx = a < b ? b : a;
        if ((mn < cmax16) & ((uint16_t)(mx - mn) >= mcc16))
          cidx.push_back(i);
      }
    }
#endif

    for (int i : cidx) {
      int cim1 = prof_[i - 1], ci = prof_[i];
      int cng = std::abs(cim1 - ci);
      int wtype, cin, cout;
      if (cim1 > ci) { wtype = DROP; cin = ci; cout = cim1; }
      else { wtype = GAIN; cin = cim1; cout = ci; }

      int maxt = -1, maxl = -1;
      double maxpe = NEG_INF;
      for (int t = 0; t < 3; t++) {
        int l = std::min(ctx(wtype, i, t), M_.lmax[t]);
        double pev = M_.pe[t * M_.lmaxp1 + l];
        if (maxpe < pev) { maxpe = pev; maxt = t; maxl = l; }
      }
      const int maxridx =
          M_.pe_idx ? M_.pe_idx[maxt * M_.lmaxp1 + maxl] : -1;

      for (int e = SELF; e <= OTHERS; e++) {
        if (wall[i] & P_BY[e]) continue;
        int ct_init = 0, ct_final = 0;
        if (cout < M_.cmax) {
          ct_init = cthres_at(M_, maxt, maxl, cout, TINIT, e);
          ct_final = cthres_at(M_, maxt, maxl, cout, TFINAL, e);
          if (!(cng > M_.max_cnt_change || cin < std::max(ct_init, 3)))
            continue;
        }
        if (e == SELF) {
          if (cout < M_.cmax && cin >= ct_final) continue;
          update_perror(i, e, wtype, cout, cin, maxpe, maxridx);
          if (perr(i, e, wtype) < M_.pe_thres[TFINAL][e]) continue;
          EIntvl I;
          bool ok = (wtype == DROP)
                        ? find_gain(i, cout, cin, e, maxt, maxl, maxpe,
                                    maxridx, I)
                        : find_drop(i, cout, cin, e, maxt, maxl, maxpe,
                                    maxridx, I);
          if (ok && I.pe >= M_.pe_thres[TFINAL][e]) {
            wall[I.b] |= W_BY[e] | P_BY[e];
            wall[I.e] |= W_BY[e] | P_BY[e];
            eintvl.push_back(I);
          }
        } else {
          if (cng >= M_.cov_h || (cout < M_.cmax && cin < ct_final)) {
            wall[i] |= W_BY[OTHERS];
            continue;
          }
          update_perror(i, e, wtype, cout, cin, maxpe, maxridx);
          if (perr(i, e, wtype) < M_.pe_thres[TFINAL][e]) {
            wall[i] |= W_BY[OTHERS];
            continue;
          }
          EIntvl I;
          bool ok = (wtype == DROP)
                        ? find_gain(i, cout, cin, e, maxt, maxl, maxpe,
                                    maxridx, I)
                        : find_drop(i, cout, cin, e, maxt, maxl, maxpe,
                                    maxridx, I);
          if (ok && I.pe >= M_.pe_thres[TFINAL][e]) {
            wall[I.b] |= P_BY[e];
            wall[I.e] |= P_BY[e];
            ointvl.push_back(I);
            continue;
          }
          wall[i] |= W_BY[OTHERS];
        }
      }
    }

    for (auto& I : ointvl) {
      wall[I.b] &= (uint8_t)~W_BY[OTHERS];
      wall[I.e] &= (uint8_t)~W_BY[OTHERS];
    }
    for (auto& I : eintvl)
      for (int j = I.b + 1; j < I.e; j++) wall[j] &= (uint8_t)~W_BY[OTHERS];

    // stable sort by (b, e); dedupe keeping first
    std::stable_sort(eintvl.begin(), eintvl.end(),
                     [](const EIntvl& a, const EIntvl& b) {
                       return a.b != b.b ? a.b < b.b : a.e < b.e;
                     });
    {
      size_t w = 0;
      for (size_t i2 = 0; i2 < eintvl.size(); i2++) {
        if (w > 0 && eintvl[w - 1].b == eintvl[i2].b &&
            eintvl[w - 1].e == eintvl[i2].e)
          continue;
        eintvl[w++] = eintvl[i2];
      }
      eintvl.resize(w);
    }
    int NS = (int)eintvl.size();

    // multi-error & boundary E-intvls (wall.c:759-860 semantics);
    // W_BY[OTHERS] is only ever set at prescreen candidates, so the
    // compacted index list covers every flagged position
    for (int i : ws_.cand_idx) {
      if (!((wall[i] & W_BY[OTHERS]) && !(wall[i] & W_BY[SELF]))) continue;
      if (wall[i] & P_MULT) continue;
      for (int w = DROP; w <= GAIN; w++) {
        double pe_i = perr(i, SELF, w);
        if (pe_i < M_.pe_thres[TFINAL][SELF]) continue;
        if (w == DROP) {
          int jmax = std::min(i + 200, plen_ + 1);
          for (int j = i + 1; j < jmax; j++) {
            if (j == plen_) {
              double pe = pe_i * pe_i;
              if (pe < M_.pe_thres[TFINAL][SELF]) continue;
              eintvl.push_back({i, plen_, pe});
              wall[i] |= P_MULT;
            }
            if (!(wall[j] & (W_BY[SELF] | W_BY[OTHERS]))) continue;
            if (bs_eintvl(NS, i, j) == -1) {
              double pe = pe_i * perr(j, SELF, GAIN);
              if (pe >= M_.pe_thres[TFINAL][SELF]) {
                eintvl.push_back({i, j, pe});
                wall[i] |= P_MULT;
                wall[j] |= P_MULT;
              }
            }
            if (wall[j] & W_BY[OTHERS]) break;
          }
        } else {
          int jmin = std::max(i - 200, 0);
          for (int j = i - 1; j >= jmin; j--) {
            if (j == 0) {
              double pe = pe_i * pe_i;
              if (pe < M_.pe_thres[TFINAL][SELF]) continue;
              eintvl.push_back({0, i, pe});
              wall[i] |= P_MULT;
            }
            if (!(wall[j] & (W_BY[SELF] | W_BY[OTHERS]))) continue;
            if (bs_eintvl(NS, j, i) == -1) {
              double pe = pe_i * perr(j, SELF, DROP);
              if (pe >= M_.pe_thres[TFINAL][SELF]) {
                eintvl.push_back({j, i, pe});
                wall[i] |= P_MULT;
                wall[j] |= P_MULT;
              }
            }
            if (wall[j] & W_BY[OTHERS]) break;
          }
        }
      }
    }

    for (size_t k = NS; k < eintvl.size(); k++)
      for (int j = eintvl[k].b + 1; j < eintvl[k].e; j++)
        wall[j] &= (uint8_t)~W_BY[OTHERS];
    if ((int)eintvl.size() > NS)
      std::stable_sort(eintvl.begin(), eintvl.end(),
                       [](const EIntvl& a, const EIntvl& b) {
                         return a.b != b.b ? a.b < b.b : a.e < b.e;
                       });

    // merge overlapping chains; originals kept (wall.c:877-908)
    {
      size_t i2 = 0;
      while (i2 + 1 < eintvl.size()) {
        int max_e = eintvl[i2].e;
        double max_pe = eintvl[i2].pe;
        size_t j = i2;
        while (j + 1 < eintvl.size()) {
          if (eintvl[j + 1].b <= eintvl[j].e) {
            max_e = std::max(max_e, eintvl[j + 1].e);
            max_pe = std::max(max_pe, eintvl[j + 1].pe);
            j++;
          } else
            break;
        }
        if (i2 < j) eintvl.push_back({eintvl[i2].b, max_e, max_pe});
        i2 = j + 1;
      }
    }
    std::stable_sort(eintvl.begin(), eintvl.end(),
                     [](const EIntvl& a, const EIntvl& b) {
                       return a.b != b.b ? a.b < b.b : a.e < b.e;
                     });
    NS = (int)eintvl.size();

    for (auto& I : eintvl)
      for (int j = I.b; j < I.e; j++) wall[j] |= ERRB;

    // emit intervals (wall.c:921-948).  Boundary positions are the
    // edges of the ERRB union plus OTHERS-flagged candidates outside it
    // plus plen — enumerated directly instead of scanning every position.
    auto& bnd = ws_.bnd;
    bnd.clear();
    {
      size_t i2 = 0;
      while (i2 < eintvl.size()) {
        int ub = eintvl[i2].b, ue = eintvl[i2].e;
        size_t j = i2 + 1;
        while (j < eintvl.size() && eintvl[j].b <= ue) {
          ue = std::max(ue, (int)eintvl[j].e);
          j++;
        }
        if (ub >= 1 && ub < plen_) bnd.push_back(ub);
        if (ue >= 1 && ue < plen_) bnd.push_back(ue);
        i2 = j;
      }
      for (int i : ws_.cand_idx)
        if (!(wall[i] & ERRB) && (wall[i] & W_BY[OTHERS])) bnd.push_back(i);
      bnd.push_back(plen_);
      std::sort(bnd.begin(), bnd.end());
      bnd.erase(std::unique(bnd.begin(), bnd.end()), bnd.end());
    }
    int N = 0, b = 0;
    for (int i : bnd) {
      int e = i;
      if (N >= out_cap) return -1;
      int idx = bs_eintvl(NS, b, e);
      double peob = std::max(perr(b, OTHERS, DROP), perr(b, OTHERS, GAIN));
      double peoe = std::max(perr(e, OTHERS, DROP), perr(e, OTHERS, GAIN));
      OutIntvl& O = out[N];
      O.b = b;
      O.e = e;
      O.cb = prof_[b];
      O.ce = prof_[e - 1];
      O.ccb = O.cce = 0;
      O.is_rel = 0;
      O.pad = 0;
      O.pe = idx != -1 ? std::log(eintvl[idx].pe) : NEG_INF;
      O.pe_o_b = peob != NEG_INF ? std::log(peob) : NEG_INF;
      O.pe_o_e = peoe != NEG_INF ? std::log(peoe) : NEG_INF;
      N++;
      b = e;
    }
    return N;
  }

  int bs_eintvl(int ns, int b, int e) const {
    int l = 0, r = ns - 1;
    const auto& v = ws_.eintvl;
    while (l <= r) {
      int m = (l + r) / 2;
      if (v[m].b == b) {
        if (v[m].e == e) return m;
        if (e > v[m].e) l = m + 1; else r = m - 1;
      } else if (b > v[m].b) l = m + 1;
      else r = m - 1;
    }
    return -1;
  }

  // wall.c:960-1013 (with the position-indexed clamp's effective remnant)
  void correct_wall_cnt(OutIntvl* iv, int i) {
    OutIntvl& I = iv[i];
    const int K = M_.K;
    int n_gain = 0;
    int last = std::min(I.b + K - 1, I.e - 1);
    for (int p = I.b; p < last; p++)
      n_gain += std::max((int)prof_[p + 1] - prof_[p], 0);
    if (I.b + K - 1 < I.e) {
      int lmx = 0;
      for (int t = 0; t < 3; t++)
        lmx = std::max(lmx, ctx(GAIN, I.b + K - 1, t) * (t + 1));
      last = std::min(I.b + lmx, plen_ - 1);
      for (int p = I.b; p < last; p++)
        n_gain -= std::max((int)prof_[p] - prof_[p + 1], 0);
    }
    int n_drop = 0;
    int first = std::max(I.e - K + 1, I.b);
    for (int p = first; p < I.e - 1; p++)
      n_drop += std::max((int)prof_[p] - prof_[p + 1], 0);
    if (I.b < I.e - K + 1) {
      int lmx = 0;
      for (int t = 0; t < 3; t++)
        lmx = std::max(lmx, ctx(DROP, I.e - K + 1, t) * (t + 1));
      first = std::max(I.e - lmx, 0);
      for (int p = first; p < I.e - 1; p++)
        n_drop -= std::max((int)prof_[p + 1] - prof_[p], 0);
    }
    I.ccb = std::min(I.cb + std::max(n_gain, 0), MAX_KMER_CNT);
    I.cce = std::min(I.ce + std::max(n_drop, 0), MAX_KMER_CNT);
    if (I.b <= i && i < std::min(I.b + 2 * K, (int)I.e) && I.ccb < prof_[i])
      I.ccb = prof_[i];
    if (std::max(I.e - 2 * K, (int)I.b) <= i && i < I.e && I.cce < prof_[i])
      I.cce = prof_[i];
  }

  // wall.c:1016-1051
  int find_rel(OutIntvl* iv, int N) {
    int Mcnt = 0;
    for (int i = 0; i < N; i++) {
      OutIntvl& I = iv[i];
      if (I.e - I.b < M_.K) continue;
      if (std::max(I.cb, I.ce) >= M_.cmax) continue;
      if (I.pe >= M_.logpthres_final_self) continue;
      correct_wall_cnt(iv, i);
      if (logp_trans(I.b, I.e, I.ccb, I.cce, (I.ccb + I.cce) / 2) <
          M_.thres_diff_rel)
        continue;
      if (std::max(I.ccb, I.cce) == MAX_KMER_CNT) continue;
      I.is_rel = 1;
      Mcnt++;
    }
    return Mcnt;
  }

 private:
  const Model& M_;
  const uint16_t* prof_;
  int plen_;
  const CtxOnDemand& cd_;
  Workspace& ws_;
};

constexpr uint8_t WallWalk::W_BY[2];
constexpr uint8_t WallWalk::P_BY[2];

thread_local Workspace g_ws;

// ---------------------------------------------------------------------
// unreliable-interval relaxation (semantics of class_unrel.c:11-300,
// fresh implementation mirroring the golden-verified Python oracle
// classpro_tpu/exact/unrel.py)
// ---------------------------------------------------------------------

enum { U_ERROR = 0, U_REPEAT = 1, U_HAPLO = 2, U_DIPLO = 3, U_NSTATE = 4 };

// Interpolated log-Skellam (same tables and arithmetic as the device
// path, classpro_tpu/tpu/skellam_dev.py: 4-point Lagrange over a
// C-replica Bessel grid; interpolation error ~1e-9, inside the
// reference Bessel's own ~1e-7 noise floor; end-to-end byte-identity is
// a measured quantity).  NULL tables fall back to the exact recurrence.
struct SkTab {
  const double* ta;  // (385, 2048) region A: h(n,x), x uniform in [0,64]
  const double* tb;  // (385, 4096) region B: g(n,x), uniform in sqrt(x)
};
constexpr int SK_NMAX = 384;
constexpr int SK_NA = 2048;
constexpr int SK_NB = 4096;
constexpr double SK_XA_MAX = 64.0;
constexpr double SK_XB_MAX = 16384.0;

static inline double sk_interp4(const double* row, int i1, double f) {
  const double w0 = -f * (f - 1.0) * (f - 2.0) / 6.0;
  const double w1 = (f + 1.0) * (f - 1.0) * (f - 2.0) / 2.0;
  const double w2 = -(f + 1.0) * f * (f - 2.0) / 2.0;
  const double w3 = (f + 1.0) * f * (f - 1.0) / 6.0;
  return w0 * row[i1 - 1] + w1 * row[i1] + w2 * row[i1 + 1] +
         w3 * row[i1 + 2];
}

static double sk_logp_skellam(const SkTab& T, int k, double lam) {
  if (T.ta == nullptr)
    return logp_skellam(k, lam);
  int n = std::abs(k);
  if (n > SK_NMAX) return NEG_INF;
  double x = 2.0 * lam;
  if (x < 0.0) x = 0.0;
  if (x > SK_XB_MAX) x = SK_XB_MAX;
  double out;
  if (x <= SK_XA_MAX) {
    double pos = x * ((SK_NA - 1) / SK_XA_MAX);
    int i1 = (int)std::floor(pos);
    if (i1 < 1) i1 = 1;
    if (i1 > SK_NA - 3) i1 = SK_NA - 3;
    double h = sk_interp4(T.ta + (int64_t)n * SK_NA, i1, pos - i1);
    double log_xh = x > 0.0 ? std::log(x / 2.0) : NEG_INF;
    out = h + n * log_xh - g_logfact[n];
    if (x == 0.0 && n == 0) out = 0.0;
  } else {
    double u = std::sqrt(x);
    const double du = (128.0 - 8.0) / (SK_NB - 1);
    double pos = (u - 8.0) / du;
    int i1 = (int)std::floor(pos);
    if (i1 < 1) i1 = 1;
    if (i1 > SK_NB - 3) i1 = SK_NB - 3;
    out = sk_interp4(T.tb + (int64_t)n * SK_NB, i1, pos - i1) + x;
  }
  if (x >= 709.782712893384 || out > 709.782712893384) out = INFINITY;
  else if (out < -745.13) out = NEG_INF;
  return -2.0 * lam + out;
}

struct UnrelGlob {
  int cov[4];        // GLOBAL_COV (E, R, H, D)
  double dr_ratio;
  int read_len;
  double r_logp;     // const.c R_LOGP
  double e_po_base;  // const.c E_PO_BASE
  double pe_mean;    // const.c PE_MEAN
  SkTab sk;
  const double* btg; // (n_cap, n_cap) log binom_test_g(k, n, 0.1) table
  int n_cap;         //   (bit-exact precompute, tables.py _btg_row)
};

// log p_errorin(OTHERS, 0.1, est, cin) with est >= cin: table row when
// in range, exact loop otherwise (rare: est >= n_cap)
static inline double u_logp_errorin_o(const UnrelGlob& G, int est, int cin);

static inline double u_logp_poisson(int k, int lam) {
  k = clamp_cnt(k);
  return k * std::log((double)lam) - lam - g_logfact[k];
}

static inline double u_logp_binom(int k, int n, double p) {
  k = clamp_cnt(k);
  n = clamp_cnt(n);
  return g_logfact[n] - g_logfact[k] - g_logfact[n - k] + k * std::log(p) +
         (n - k) * std::log(1 - p);
}

static inline double u_lin_interp(int x, int pos1, int cnt1, int pos2,
                                  int cnt2) {
  return (double)cnt1 +
         ((double)cnt2 - cnt1) * (x - pos1) / (pos2 - pos1);
}

static inline double u_logp_trans(int b, int e, int cb, int ce, int cov,
                                  int read_len) {
  return logp_skellam(ce - cb, (double)cov * std::abs(e - b) / read_len);
}

static inline double u_safe_log(double x) {
  return x > 0.0 ? std::log(x) : NEG_INF;
}

static inline double u_logp_errorin_o(const UnrelGlob& G, int est, int cin) {
  int k = est - cin;
  if (G.btg && est >= 1 && est < G.n_cap && k < G.n_cap)
    return G.btg[(size_t)est * G.n_cap + k];
  return u_safe_log(p_errorin(OTHERS, 0.1, est, cin));
}

// nearest reliable intervals with state s on each side (class_unrel.c:11-25)
static inline void u_find_nn(const OutIntvl* iv, const int8_t* asgn, int N,
                             int idx, int s, int* lo, int* ro) {
  int l = idx - 1;
  while (l >= 0 && !(asgn[l] == s && iv[l].is_rel)) l--;
  int r = idx + 1;
  while (r < N && !(asgn[r] == s && iv[r].is_rel)) r++;
  if (r >= N) r = -1;
  *lo = l;
  *ro = r;
}

// estimated coverage at position x for state s (class_unrel.c:27-51);
// (l,r) = nearest rel-s pair, (lo,ro) = nearest rel-other-state pair
// (precomputed by the caller — the reference recomputes the same scans)
static int u_est_cov(const UnrelGlob& G, const OutIntvl* iv, int x, int s,
                     int l, int r, int lo, int ro) {
  if (l != -1 && r != -1)
    return (int)u_lin_interp(x, iv[l].e - 1, iv[l].cce, iv[r].b, iv[r].ccb);
  if (l != -1) return iv[l].cce;
  if (r != -1) return iv[r].ccb;
  // cross-state fallback (from_est = true leg of the reference recursion)
  int cov;
  if (lo != -1 && ro != -1)
    cov = (int)u_lin_interp(x, iv[lo].e - 1, iv[lo].cce, iv[ro].b,
                            iv[ro].ccb);
  else if (lo != -1)
    cov = iv[lo].cce;
  else if (ro != -1)
    cov = iv[ro].ccb;
  else
    cov = 0;
  if (cov > 0) return s == U_HAPLO ? cov / 2 : cov * 2;
  return G.cov[s];
}

static inline double u_logp_e(const UnrelGlob& G, const OutIntvl& I) {
  double lp = u_logp_poisson(I.cb, G.cov[U_ERROR]) +
              u_logp_poisson(I.ce, G.cov[U_ERROR]) + G.e_po_base;
  return I.pe > lp ? I.pe : lp;
}

static double u_logp_r(const UnrelGlob& G, const OutIntvl* iv, int idx,
                        int l, int r) {
  const OutIntvl& I = iv[idx];
  if ((I.cb > I.ce ? I.cb : I.ce) >= G.cov[U_REPEAT]) return 0.0;
  int dcov_l, dcov_r;
  if (l == -1 && r == -1)
    dcov_l = dcov_r = G.cov[U_DIPLO];
  else if (l == -1)
    dcov_l = dcov_r = iv[r].cb;
  else if (r == -1)
    dcov_l = dcov_r = iv[l].ce;
  else {
    dcov_l = iv[l].ce;
    dcov_r = iv[r].cb;
  }
  int rcov_l = (int)(G.dr_ratio * dcov_l);
  int rcov_r = (int)(G.dr_ratio * dcov_r);
  if (I.cb >= rcov_l || I.ce >= rcov_r) return G.r_logp;
  return u_logp_binom(I.cb, rcov_l, 1 - G.pe_mean) +
         u_logp_binom(I.ce, rcov_r, 1 - G.pe_mean);
}

static double u_logp_hd(const UnrelGlob& G, const OutIntvl* iv,
                        const int8_t* asgn, int N, int s, int idx,
                        int l_rel, int r_rel, int lo, int ro) {
  const OutIntvl& I = iv[idx];

  double logp_l_er = NEG_INF, logp_l_sf = NEG_INF, logp_l_sf_er = NEG_INF;
  if (idx - 1 >= 0 && asgn[idx - 1] == s) logp_l_er = I.pe_o_b;
  if (l_rel != -1) {
    const OutIntvl& L = iv[l_rel];
    logp_l_sf = sk_logp_skellam(
        G.sk, I.cb - L.cce,
        (double)L.cce * std::abs(I.b - (L.e - 1)) / G.read_len);
  }
  int est_cnt = u_est_cov(G, iv, I.b, s, l_rel, r_rel, lo, ro);
  if (est_cnt >= I.cb)
    logp_l_sf_er = u_logp_errorin_o(G, est_cnt, I.cb);
  double logp_l = logp_l_er;
  if (logp_l_sf > logp_l) logp_l = logp_l_sf;
  if (logp_l_sf_er > logp_l) logp_l = logp_l_sf_er;

  double logp_r_er = NEG_INF, logp_r_sf = NEG_INF, logp_r_sf_er = NEG_INF;
  if (idx + 1 < N && asgn[idx + 1] == s) logp_r_er = I.pe_o_e;
  if (r_rel != -1) {
    const OutIntvl& R = iv[r_rel];
    logp_r_sf = sk_logp_skellam(
        G.sk, R.ccb - I.ce,
        (double)R.ccb * std::abs(R.b - (I.e - 1)) / G.read_len);
  }
  est_cnt = u_est_cov(G, iv, I.e - 1, s, l_rel, r_rel, lo, ro);
  if (est_cnt >= I.ce)
    logp_r_sf_er = u_logp_errorin_o(G, est_cnt, I.ce);
  double logp_r = logp_r_er;
  if (logp_r_sf > logp_r) logp_r = logp_r_sf;
  if (logp_r_sf_er > logp_r) logp_r = logp_r_sf_er;

  if (logp_l == NEG_INF && logp_r == NEG_INF) {
    logp_l = u_logp_poisson(I.cb, G.cov[s]);
    logp_r = u_logp_poisson(I.ce, G.cov[s]);
  } else if (logp_l == NEG_INF) {
    logp_l = logp_r;
  } else if (logp_r == NEG_INF) {
    logp_r = logp_l;
  }
  return logp_l + logp_r;
}

// Relaxation scratch: the nearest-reliable-H/D searches (sorted index
// lists + binary search instead of O(N) scans) and every state-logp
// term that depends only on (interval, rel-neighborhood) are memoized;
// per update only the dynamic adjacent-state pe_o gates re-evaluate.
// The rel-H/D sets change ONLY when a non-fixed is_rel interval (DP
// state E/R) is re-assigned — the lists are edited then, and affected
// memos invalidate through the (lH,rH,lD,rD) key.  The arithmetic per
// update is identical to the direct form (class_unrel.c:192-246).
struct URelax {
  std::vector<int> relH, relD;
  struct Memo {
    int key[4] = {-2, -2, -2, -2};
    double logpR;
    double statH_l, statH_r, statD_l, statD_r;  // max(sf, sf_er) sides
  };
  std::vector<Memo> memo;
  std::vector<double> logpE;
  std::vector<uint8_t> einit;
};

static inline void u_nn_list(const std::vector<int>& v, int idx, int* lo,
                             int* ro) {
  auto it = std::lower_bound(v.begin(), v.end(), idx);
  *lo = it == v.begin() ? -1 : *(it - 1);
  while (it != v.end() && *it == idx) ++it;
  *ro = it == v.end() ? -1 : *it;
}

static inline void u_list_set(std::vector<int>& v, int idx, bool member) {
  auto it = std::lower_bound(v.begin(), v.end(), idx);
  bool in = it != v.end() && *it == idx;
  if (member && !in) v.insert(it, idx);
  else if (!member && in) v.erase(it);
}

// static sides of u_logp_hd: max(skellam drift to the nearest rel-s,
// errors-in-others vs the interpolated estimate)
static inline void u_hd_static(const UnrelGlob& G, const OutIntvl* iv,
                               int idx, int s, int l_rel, int r_rel,
                               int lo, int ro, double* out_l,
                               double* out_r) {
  const OutIntvl& I = iv[idx];
  double sf = NEG_INF, sf_er = NEG_INF;
  if (l_rel != -1) {
    const OutIntvl& L = iv[l_rel];
    sf = sk_logp_skellam(
        G.sk, I.cb - L.cce,
        (double)L.cce * std::abs(I.b - (L.e - 1)) / G.read_len);
  }
  int est_cnt = u_est_cov(G, iv, I.b, s, l_rel, r_rel, lo, ro);
  if (est_cnt >= I.cb) sf_er = u_logp_errorin_o(G, est_cnt, I.cb);
  *out_l = sf > sf_er ? sf : sf_er;

  sf = NEG_INF; sf_er = NEG_INF;
  if (r_rel != -1) {
    const OutIntvl& R = iv[r_rel];
    sf = sk_logp_skellam(
        G.sk, R.ccb - I.ce,
        (double)R.ccb * std::abs(R.b - (I.e - 1)) / G.read_len);
  }
  est_cnt = u_est_cov(G, iv, I.e - 1, s, l_rel, r_rel, lo, ro);
  if (est_cnt >= I.ce) sf_er = u_logp_errorin_o(G, est_cnt, I.ce);
  *out_r = sf > sf_er ? sf : sf_er;
}

// dynamic-gate combine for one H/D state (tail of u_logp_hd)
static inline double u_hd_combine(const UnrelGlob& G, const OutIntvl& I,
                                  const int8_t* asgn, int N, int idx,
                                  int s, double stat_l, double stat_r) {
  double er_l = (idx - 1 >= 0 && asgn[idx - 1] == s) ? I.pe_o_b : NEG_INF;
  double er_r = (idx + 1 < N && asgn[idx + 1] == s) ? I.pe_o_e : NEG_INF;
  double l = er_l > stat_l ? er_l : stat_l;
  double r = er_r > stat_r ? er_r : stat_r;
  if (l == NEG_INF && r == NEG_INF) {
    l = u_logp_poisson(I.cb, G.cov[s]);
    r = u_logp_poisson(I.ce, G.cov[s]);
  } else if (l == NEG_INF) {
    l = r;
  } else if (r == NEG_INF) {
    r = l;
  }
  return l + r;
}

// one relaxation update (class_unrel.c:192-246), memoized form
static void u_update_state(const UnrelGlob& G, const OutIntvl* iv,
                           int8_t* asgn, int N, int idx, URelax& U) {
  const OutIntvl& I = iv[idx];
  int8_t old = asgn[idx];
  if ((I.cb > I.ce ? I.cb : I.ce) >= G.cov[U_REPEAT]) {
    asgn[idx] = U_REPEAT;
  } else {
    int lH, rH, lD, rD;
    u_nn_list(U.relH, idx, &lH, &rH);
    u_nn_list(U.relD, idx, &lD, &rD);
    auto& M = U.memo[idx];
    if (M.key[0] != lH || M.key[1] != rH || M.key[2] != lD ||
        M.key[3] != rD) {
      M.key[0] = lH; M.key[1] = rH; M.key[2] = lD; M.key[3] = rD;
      M.logpR = u_logp_r(G, iv, idx, lD, rD);
      u_hd_static(G, iv, idx, U_HAPLO, lH, rH, lD, rD, &M.statH_l,
                  &M.statH_r);
      u_hd_static(G, iv, idx, U_DIPLO, lD, rD, lH, rH, &M.statD_l,
                  &M.statD_r);
    }
    if (!U.einit[idx]) {
      U.einit[idx] = 1;
      U.logpE[idx] = u_logp_e(G, I);
    }
    // same scan order as the reference: E, R, H, D
    double logpmax = NEG_INF, runner = NEG_INF;
    int smax = -1;
    for (int s = 0; s < 4; s++) {
      double logp;
      if (s == U_ERROR)
        logp = U.logpE[idx];
      else if (s == U_REPEAT)
        logp = M.logpR;
      else if (s == U_HAPLO)
        logp = u_hd_combine(G, I, asgn, N, idx, U_HAPLO, M.statH_l,
                            M.statH_r);
      else
        logp = u_hd_combine(G, I, asgn, N, idx, U_DIPLO, M.statD_l,
                            M.statD_r);
      if (logpmax < logp) {
        runner = logpmax;
        logpmax = logp;
        smax = s;
      } else if (runner < logp) {
        runner = logp;
      }
    }
    // exactness guard (same contract as the device DP's, see
    // tpu/rel_dev2.py): the H/D static legs pass through the Skellam
    // interpolation table (~1e-9 error, sk_logp_skellam); an argmax
    // margin below 1e-5 is re-decided with exact Bessel terms — the
    // reference binary's own arithmetic — including its first-wins
    // tie order.  Everything else here (logpE, logpR, the combine
    // gates) is already bit-exact vs the reference.
    if (G.sk.ta != nullptr && smax != -1 && runner != NEG_INF &&
        logpmax - runner < 1e-5) {
      UnrelGlob Gx = G;
      Gx.sk.ta = nullptr;
      Gx.sk.tb = nullptr;
      double shl, shr, sdl, sdr;
      u_hd_static(Gx, iv, idx, U_HAPLO, lH, rH, lD, rD, &shl, &shr);
      u_hd_static(Gx, iv, idx, U_DIPLO, lD, rD, lH, rH, &sdl, &sdr);
      logpmax = NEG_INF;
      smax = -1;
      for (int s = 0; s < 4; s++) {
        double logp;
        if (s == U_ERROR)
          logp = U.logpE[idx];
        else if (s == U_REPEAT)
          logp = M.logpR;
        else if (s == U_HAPLO)
          logp = u_hd_combine(G, I, asgn, N, idx, U_HAPLO, shl, shr);
        else
          logp = u_hd_combine(G, I, asgn, N, idx, U_DIPLO, sdl, sdr);
        if (logpmax < logp) {
          logpmax = logp;
          smax = s;
        }
      }
    }
    if (smax != -1 && asgn[idx] != smax) asgn[idx] = (int8_t)smax;
  }
  if (iv[idx].is_rel && asgn[idx] != old) {
    u_list_set(U.relH, idx, asgn[idx] == U_HAPLO);
    u_list_set(U.relD, idx, asgn[idx] == U_DIPLO);
  }
}

// two relaxation sweeps for one read (class_unrel.c:248-300)
static void u_classify_read(const UnrelGlob& G, const OutIntvl* iv,
                            int8_t* asgn, int N, int* ord) {
  for (int i = 0; i < N; i++) ord[i] = i;
  std::stable_sort(ord, ord + N, [&](int a, int b) {
    int ka = iv[a].cb < iv[a].ce ? iv[a].cb : iv[a].ce;
    int kb = iv[b].cb < iv[b].ce ? iv[b].cb : iv[b].ce;
    return ka < kb;
  });
  thread_local URelax U;
  U.relH.clear();
  U.relD.clear();
  U.memo.assign(N, {});
  U.logpE.resize(N);
  U.einit.assign(N, 0);
  for (int i = 0; i < N; i++) {
    if (iv[i].is_rel && asgn[i] == U_HAPLO) U.relH.push_back(i);
    if (iv[i].is_rel && asgn[i] == U_DIPLO) U.relD.push_back(i);
  }
  std::vector<bool> fixed(N);
  for (int i = 0; i < N; i++)
    fixed[i] = iv[i].is_rel && (asgn[i] == U_HAPLO || asgn[i] == U_DIPLO);
  for (int i = N - 1; i >= 0; i--)
    if (!fixed[ord[i]]) u_update_state(G, iv, asgn, N, ord[i], U);
  for (int i = 0; i < N; i++)
    if (!fixed[ord[i]]) u_update_state(G, iv, asgn, N, ord[i], U);
}

}  // namespace

extern "C" {

// context implementations exposed for the equivalence test
void cp_seq_context(const char* seq, int rlen, uint8_t* lctx, uint8_t* rctx,
                    int fast) {
  memset(lctx, 0, (size_t)rlen * 3);
  memset(rctx, 0, (size_t)rlen * 3);
  if (fast) {
    CtxOnDemand cd{seq, rlen};
    for (int i = 0; i < rlen; i++)
      for (int t = 0; t < 3; t++) {
        lctx[i * 3 + t] = (uint8_t)cd.l(i, t);
        rctx[i * 3 + t] = (uint8_t)cd.r(i, t);
      }
  } else {
    seq_context(seq, rlen, lctx, rctx);
  }
}

// Profile decode (libfastk.c:1464-1534 stream format)
int cp_decode_profile(const uint8_t* buf, int64_t len, uint16_t* out,
                      int out_cap) {
  if (len == 0) return 0;
  int64_t p = 0;
  uint16_t x = buf[p++], d;
  if (x & 0x80) d = (uint16_t)(((x & 0x7f) << 8) | buf[p++]);
  else d = x;
  int n = 0;
  if (n < out_cap) out[n] = d;
  n++;
  // fast loop: one input byte expands to at most 63 outputs (run max
  // 0x3f), so while n+64 fits in out_cap no per-element bound checks
  // are needed and a run can be filled with unconditional full-width
  // stores (the tail beyond x is overwritten by later outputs)
  while (p < len && n + 64 <= out_cap) {
    x = buf[p++];
    if ((x & 0xc0) == 0) {
#if defined(__AVX2__)
      __m256i vd = _mm256_set1_epi16((short)d);
      _mm256_storeu_si256((__m256i*)(out + n), vd);
      _mm256_storeu_si256((__m256i*)(out + n + 16), vd);
      _mm256_storeu_si256((__m256i*)(out + n + 32), vd);
      _mm256_storeu_si256((__m256i*)(out + n + 48), vd);
#else
      std::fill_n(out + n, x, d);
#endif
      n += x;
    } else if (x & 0x80) {
      uint16_t v;
      if (x & 0x40) v = (uint16_t)((x << 8) | buf[p++]);
      else v = (uint16_t)((((x << 8) & 0x7fff)) | buf[p++]);
      d = (uint16_t)((d + v) & 0x7fff);
      out[n++] = d;
    } else {
      if (x & 0x20) d = (uint16_t)(d + ((x & 0x1f) | 0xffe0));
      else d = (uint16_t)(d + (x & 0x1f));
      out[n++] = d;
    }
  }
  while (p < len) {
    x = buf[p++];
    if ((x & 0xc0) == 0) {
      for (int i = 0; i < x; i++) {
        if (n < out_cap) out[n] = d;
        n++;
      }
    } else if (x & 0x80) {
      uint16_t v;
      if (x & 0x40) v = (uint16_t)((x << 8) | buf[p++]);
      else v = (uint16_t)((((x << 8) & 0x7fff)) | buf[p++]);
      d = (uint16_t)((d + v) & 0x7fff);
      if (n < out_cap) out[n] = d;
      n++;
    } else {
      if (x & 0x20) d = (uint16_t)(d + ((x & 0x1f) | 0xffe0));
      else d = (uint16_t)(d + (x & 0x1f));
      if (n < out_cap) out[n] = d;
      n++;
    }
  }
  return n;
}

// Full wall stage for one read: context + walls + reliable intervals.
// out holds OutIntvl records; returns N (or -1 if out_cap exceeded).
int cp_wall_stage(
    // model
    int K, int cmax, int cov_h, int read_len, int max_n_hc,
    int min_cnt_change, int max_cnt_change, const double* pe_thres4,
    double thres_diff_eo, double thres_diff_rel, double hc_erate,
    const int* lmax3, int lmaxp1, const double* pe, const int16_t* cthres,
    // read
    const char* seq, int rlen, const uint16_t* prof, int plen,
    // out
    OutIntvl* out, int out_cap, int* n_rel) {
  init_logfact();
  Model M;
  M.K = K; M.cmax = cmax; M.cov_h = cov_h; M.read_len = read_len;
  M.max_n_hc = max_n_hc; M.min_cnt_change = min_cnt_change;
  M.max_cnt_change = max_cnt_change;
  M.pe_thres[0][0] = pe_thres4[0]; M.pe_thres[0][1] = pe_thres4[1];
  M.pe_thres[1][0] = pe_thres4[2]; M.pe_thres[1][1] = pe_thres4[3];
  M.thres_diff_eo = thres_diff_eo; M.thres_diff_rel = thres_diff_rel;
  M.hc_erate = hc_erate;
  M.lmax[0] = lmax3[0]; M.lmax[1] = lmax3[1]; M.lmax[2] = lmax3[2];
  M.lmaxp1 = lmaxp1; M.pe = pe; M.cthres = cthres;
  M.logpthres_final_self = std::log(M.pe_thres[TFINAL][SELF]);

  CtxOnDemand cd{seq, rlen};

  WallWalk W(M, prof, plen, cd, g_ws);
  int N = W.run(out, out_cap);
  if (N < 0) return -1;
  *n_rel = W.find_rel(out, N);
  return N;
}

// The model of a wall stage call (mirror of estimation.GlobalModel +
// Defaults, with the tail tables of tables.py).
static void wall_model(
    Model& M, int K, int cmax, int cov_h, int read_len, int max_n_hc,
    int min_cnt_change, int max_cnt_change, const double* pe_thres4,
    double thres_diff_eo, double thres_diff_rel, double hc_erate,
    const int* lmax3, int lmaxp1, const double* pe, const int16_t* cthres,
    const double* btg, const double* erates, const int32_t* pe_idx,
    int hc_idx, int n_cap) {
  M.K = K; M.cmax = cmax; M.cov_h = cov_h; M.read_len = read_len;
  M.max_n_hc = max_n_hc; M.min_cnt_change = min_cnt_change;
  M.max_cnt_change = max_cnt_change;
  M.pe_thres[0][0] = pe_thres4[0]; M.pe_thres[0][1] = pe_thres4[1];
  M.pe_thres[1][0] = pe_thres4[2]; M.pe_thres[1][1] = pe_thres4[3];
  M.thres_diff_eo = thres_diff_eo; M.thres_diff_rel = thres_diff_rel;
  M.hc_erate = hc_erate;
  M.lmax[0] = lmax3[0]; M.lmax[1] = lmax3[1]; M.lmax[2] = lmax3[2];
  M.lmaxp1 = lmaxp1; M.pe = pe; M.cthres = cthres;
  M.logpthres_final_self = std::log(M.pe_thres[TFINAL][SELF]);
  M.btg = btg; M.erates = erates; M.pe_idx = pe_idx;
  M.hc_idx = hc_idx; M.n_cap = n_cap;
}

// One read of a batched wall stage: its records at out (a slot of
// `slot`), n_out = record count (-1 if the slot overflowed; the caller
// retries with a larger slot), n_rel = reliable count; walked in the
// worker's kept workspace (g_ws), so a read's records do not depend on
// the worker that walks it.
static void wall_read(const Model& M, const char* seq, int rlen,
                      const uint16_t* prof, int plen, OutIntvl* out,
                      int slot, int* n_out, int* n_rel,
                      long long* t_run = nullptr,
                      long long* t_rel = nullptr) {
  CtxOnDemand cd{seq, rlen};
  WallWalk W(M, prof, plen, cd, g_ws);
  long long t0 = t_run ? now_ns() : 0;
  int N = W.run(out, slot);
  if (t_run) *t_run += now_ns() - t0;
  if (N < 0) { *n_out = -1; *n_rel = 0; return; }
  if (t_rel) t0 = now_ns();
  *n_rel = W.find_rel(out, N);
  if (t_rel) *t_rel += now_ns() - t0;
  *n_out = N;
}

// Batched wall stage over the host plane's workers (replaces the
// reference's per-thread read loop, ClassPro.c:146-304, for the host side
// of the pipeline).  Reads stay in their caller-owned buffers: seqs[i]
// (seq_len[i] bytes) and profs[i] (prof_len[i] counts).  Each read
// writes to a fixed slot of `slot` records at out + i*slot (wall_read).
// Reads go to the workers off an atomic counter.
void cp_wall_stage_batch_ptr(
    int K, int cmax, int cov_h, int read_len, int max_n_hc,
    int min_cnt_change, int max_cnt_change, const double* pe_thres4,
    double thres_diff_eo, double thres_diff_rel, double hc_erate,
    const int* lmax3, int lmaxp1, const double* pe, const int16_t* cthres,
    const double* btg, const double* erates, const int32_t* pe_idx,
    int hc_idx, int n_cap,
    int n_reads, const char* const* seqs, const int32_t* seq_len,
    const uint16_t* const* profs, const int32_t* prof_len,
    OutIntvl* out, int slot, int* n_out, int* n_rel, int threads) {
  init_logfact();
  Model M;
  wall_model(M, K, cmax, cov_h, read_len, max_n_hc, min_cnt_change,
             max_cnt_change, pe_thres4, thres_diff_eo, thres_diff_rel,
             hc_erate, lmax3, lmaxp1, pe, cthres, btg, erates, pe_idx,
             hc_idx, n_cap);

  const bool prof_on = std::getenv("CP_PROF") != nullptr;
  std::atomic<long long> t_run(0), t_rel(0);

  pool::parallel_rows(n_reads, threads, [&](int i) {
    long long tr = 0, tl = 0;
    wall_read(M, seqs[i], seq_len[i], profs[i], prof_len[i],
              out + (int64_t)i * slot, slot, n_out + i, n_rel + i,
              prof_on ? &tr : nullptr, prof_on ? &tl : nullptr);
    if (prof_on) { t_run += tr; t_rel += tl; }
  });
  if (prof_on)
    std::fprintf(stderr, "[cp_prof] wall_ptr run=%.2fms find_rel=%.2fms\n",
                 t_run.load() / 1e6, t_rel.load() / 1e6);
}

// The wall stage with each read's FASTK profile decoded in the worker
// that walks it: read i's sequence is seq_len[i] bytes at address
// seq_addr[i] (the FASTX reader's chunk buffer), its compressed profile
// prof_nb[i] bytes at prof_addr[i] (its part, mapped read-only), and
// its profile length is plen[i].  The worker decodes into a buffer of
// its own (cp_decode_profile) and runs wall_read on it at once; dec_n[i]
// is the decoded length.  A read whose decoded length is not plen[i] is
// not walked (n_out 0, n_rel 0); the caller raises for it.
void cp_wall_stage_fastk(
    int K, int cmax, int cov_h, int read_len, int max_n_hc,
    int min_cnt_change, int max_cnt_change, const double* pe_thres4,
    double thres_diff_eo, double thres_diff_rel, double hc_erate,
    const int* lmax3, int lmaxp1, const double* pe, const int16_t* cthres,
    const double* btg, const double* erates, const int32_t* pe_idx,
    int hc_idx, int n_cap,
    int n_reads, const int64_t* seq_addr, const int32_t* seq_len,
    const int64_t* prof_addr, const int64_t* prof_nb, const int32_t* plen,
    OutIntvl* out, int slot, int* n_out, int* n_rel, int32_t* dec_n,
    int threads) {
  init_logfact();
  Model M;
  wall_model(M, K, cmax, cov_h, read_len, max_n_hc, min_cnt_change,
             max_cnt_change, pe_thres4, thres_diff_eo, thres_diff_rel,
             hc_erate, lmax3, lmaxp1, pe, cthres, btg, erates, pe_idx,
             hc_idx, n_cap);
  pool::parallel_rows(n_reads, threads, [&](int i) {
    thread_local std::vector<uint16_t> prof;
    if ((int64_t)prof.size() < plen[i]) prof.resize(plen[i]);
    const int n = cp_decode_profile(
        reinterpret_cast<const uint8_t*>(prof_addr[i]), prof_nb[i],
        prof.data(), plen[i]);
    dec_n[i] = n;
    if (n != plen[i]) { n_out[i] = 0; n_rel[i] = 0; return; }
    wall_read(M, reinterpret_cast<const char*>(seq_addr[i]), seq_len[i],
              prof.data(), plen[i], out + (int64_t)i * slot, slot,
              n_out + i, n_rel + i);
  });
}

// Pack the reliable intervals of a wall-stage slab into the rel-only
// device transfer blobs (layout: classpro_tpu/tpu/device_pipeline.py
// rel_only_dev docstring).  Row j enumerates reads with n_rel > 0 in
// read order; padding rows/cols use the neutral values the device
// pipeline expects (b=0, e=1, ccb=cce=1, pe=-inf, m=plen=1).
void cp_pack_rel(int n_reads, const OutIntvl* iv, int slot,
                 const int* n_iv, const int* n_rel, const int64_t* plens,
                 int R, int max_m, int32_t* iblob, double* fblob) {
  const size_t sz = (size_t)R * max_m;
  int32_t* b = iblob;
  int32_t* e = iblob + sz;
  int32_t* ccb = iblob + 2 * sz;
  int32_t* cce = iblob + 3 * sz;
  int32_t* m = iblob + 4 * sz;
  int32_t* plen = iblob + 4 * sz + R;
  for (size_t k = 0; k < sz; k++) {
    b[k] = 0; e[k] = 1; ccb[k] = 1; cce[k] = 1; fblob[k] = NEG_INF;
  }
  for (int r = 0; r < R; r++) { m[r] = 1; plen[r] = 1; }
  int j = 0;
  for (int i = 0; i < n_reads; i++) {
    if (n_rel[i] <= 0) continue;
    const OutIntvl* ivr = iv + (int64_t)i * slot;
    int w = 0;
    const size_t row = (size_t)j * max_m;
    for (int k = 0; k < n_iv[i]; k++) {
      if (!ivr[k].is_rel) continue;
      b[row + w] = ivr[k].b;
      e[row + w] = ivr[k].e;
      ccb[row + w] = ivr[k].ccb;
      cce[row + w] = ivr[k].cce;
      fblob[row + w] = ivr[k].pe;
      w++;
    }
    m[j] = n_rel[i];
    plen[j] = (int32_t)plens[i];
    j++;
  }
}

// Finish stage for one chunk: scatter the device's reliable assignments
// back onto each read's interval list (row j = j-th read with
// n_rel > 0, same enumeration as cp_pack_rel), run the relaxation
// sweeps, and expand to class characters -- one call, its reads on the
// host plane's workers (each read's bytes written by one worker).
void cp_finish_batch(int cov_e, int cov_r, int cov_h, int cov_d,
                     double dr_ratio, int read_len, double r_logp,
                     double e_po_base, double pe_mean,
                     const double* sk_ta, const double* sk_tb,
                     const double* btg_log, int n_cap, int n_reads,
                     const OutIntvl* iv, int slot, const int* n_iv,
                     const int* n_rel, const int8_t* rel_out, int max_m,
                     int K, const int64_t* out_off, char* out,
                     int threads) {
  init_logfact();
  UnrelGlob G;
  G.cov[0] = cov_e; G.cov[1] = cov_r; G.cov[2] = cov_h; G.cov[3] = cov_d;
  G.dr_ratio = dr_ratio; G.read_len = read_len;
  G.r_logp = r_logp; G.e_po_base = e_po_base; G.pe_mean = pe_mean;
  G.sk.ta = sk_ta; G.sk.tb = sk_tb;
  G.btg = btg_log; G.n_cap = n_cap;
  static const char stoc[4] = {'E', 'R', 'H', 'D'};

  // rel-row index of each read (enumeration order of cp_pack_rel)
  std::vector<int> rel_row(n_reads, -1);
  {
    int j = 0;
    for (int i = 0; i < n_reads; i++)
      if (n_rel[i] > 0) rel_row[i] = j++;
  }

  const bool prof_on = std::getenv("CP_PROF") != nullptr;
  std::atomic<long long> t_relax(0);

  pool::parallel_rows(n_reads, threads, [&](int i) {
    thread_local std::vector<int> ord;
    thread_local std::vector<int8_t> asgn;
    char* dst = out + out_off[i];
    int64_t len = out_off[i + 1] - out_off[i];
    memset(dst, 'N', (size_t)len);
    int N = n_iv[i];
    if (N <= 0) return;
    if (ord.size() < (size_t)N) {
      ord.resize(N);
      asgn.resize(N);
    }
    const OutIntvl* ivr = iv + (int64_t)i * slot;
    for (int k = 0; k < N; k++) asgn[k] = U_NSTATE;
    if (rel_row[i] >= 0 && rel_out) {
      const int8_t* rr = rel_out + (size_t)rel_row[i] * max_m;
      int w = 0;
      for (int k = 0; k < N; k++)
        if (ivr[k].is_rel) asgn[k] = rr[w++];
    }
    long long t0 = prof_on ? now_ns() : 0;
    u_classify_read(G, ivr, asgn.data(), N, ord.data());
    if (prof_on) t_relax += now_ns() - t0;
    for (int k = 0; k < N; k++) {
      int a = asgn[k];
      if (a < 0) a = 0;
      if (a > 3) a = 3;
      int bb = ivr[k].b, ee = ivr[k].e;
      if (bb < 0) bb = 0;
      if (K - 1 + ee > len) ee = (int)len - (K - 1);
      if (ee > bb) memset(dst + K - 1 + bb, stoc[a], (size_t)(ee - bb));
    }
  });
  if (prof_on)
    std::fprintf(stderr, "[cp_prof] finish relax=%.2fms\n",
                 t_relax.load() / 1e6);
}

}  // extern "C"

// ===========================================================================
// Seed selection (-s): C++ port of classpro_tpu/seeds.py (ref seed.c,
// nthash.h).  Exact semantics of the byte-validated Python port, including
// the reference's stale-slot mask-interval behavior (seed.c:125-188) and
// the stable nw sort (glibc qsort order).  Single worker + ONE persistent
// workspace = the reference's -T1 semantics (what the goldens pin).
// ===========================================================================

namespace seeds {

constexpr int WSIZE = 1000;
constexpr int WSIZE_REP = 200;
constexpr int BOUNDARY_UNIQ_LEN = 2000;
constexpr uint64_t HMOD = 2147483647ull;

static inline uint64_t rol1(uint64_t v) { return (v << 1) | (v >> 63); }
static inline uint64_t swapbits033(uint64_t v) {
  uint64_t x = (v ^ (v >> 33)) & 1;
  return v ^ (x | (x << 33));
}
static inline uint64_t Rt(uint64_t v) { return swapbits033(rol1(v)); }

// taps[j][c]: fwd = R^(K-1-j)(seed_c); rev = R^j(seed_comp(c))
struct HashTaps {
  int K = -1;
  std::vector<uint64_t> fwd, rev;  // (K, 256)
};

static void build_taps(HashTaps& T, int K) {
  static const unsigned char bases[4] = {'A', 'C', 'G', 'T'};
  static const uint64_t seedv[4] = {0x3C8BFBB395C60474ull,
                                    0x3193C18562A02B4Cull,
                                    0x20323ED082572324ull,
                                    0x295549F54BE24456ull};
  static const int comp[4] = {3, 2, 1, 0};  // A<->T, C<->G
  T.K = K;
  T.fwd.assign((size_t)K * 256, 0);
  T.rev.assign((size_t)K * 256, 0);
  for (int b = 0; b < 4; b++) {
    std::vector<uint64_t> powers(K);
    uint64_t v = seedv[b];
    for (int r = 0; r < K; r++) { powers[r] = v; v = Rt(v); }
    std::vector<uint64_t> cpow(K);
    v = seedv[comp[b]];
    for (int r = 0; r < K; r++) { cpow[r] = v; v = Rt(v); }
    for (int j = 0; j < K; j++) {
      unsigned char up = bases[b], lo = (unsigned char)(bases[b] + 32);
      T.fwd[(size_t)j * 256 + up] = powers[K - 1 - j];
      T.fwd[(size_t)j * 256 + lo] = powers[K - 1 - j];
      T.rev[(size_t)j * 256 + up] = cpow[j];
      T.rev[(size_t)j * 256 + lo] = cpow[j];
    }
  }
}

// canonical ntHash (mod 2^31-1) per profile position, rolling update:
//   f_{i+1} = R(f_i) ^ R^K(seed(s[i])) ^ seed(s[i+K])
//   r_{i+1} = Rinv(r_i ^ seedc(s[i])) ^ R^(K-1)(seedc(s[i+K]))
static void kmer_hash(const HashTaps& T, const char* seq, int plen, int K,
                      int64_t* out) {
  const uint64_t* f0 = T.fwd.data();          // j = 0 row: R^(K-1)(seed)
  const uint64_t* fK = T.fwd.data() + (size_t)(K - 1) * 256;  // seed_c
  const uint64_t* r0 = T.rev.data();          // seedc
  const uint64_t* rK = T.rev.data() + (size_t)(K - 1) * 256;  // R^(K-1)
  uint64_t f = 0, r = 0;
  for (int j = 0; j < K; j++) {
    unsigned char c = (unsigned char)seq[j];
    f ^= T.fwd[(size_t)j * 256 + c];
    r ^= T.rev[(size_t)j * 256 + c];
  }
  uint64_t h = f < r ? f : r;
  out[0] = (int64_t)(h % HMOD);
  for (int i = 1; i < plen; i++) {
    unsigned char cout = (unsigned char)seq[i - 1];
    unsigned char cin = (unsigned char)seq[i + K - 1];
    f = Rt(f) ^ Rt(f0[cout]) ^ fK[cin];
    uint64_t rr = r ^ r0[cout];
    rr = swapbits033(rr);
    rr = (rr >> 1) | (rr << 63);              // ror1: inverse of R
    r = rr ^ rK[cin];
    h = f < r ? f : r;
    out[i] = (int64_t)(h % HMOD);
  }
}

struct Seg {
  int b, e, cnt, nw;
  bool is_seed;
};

// mask-interval workspace with the reference's stale-slot semantics
// (seeds.py Workspace docstring; seed.c:125-188)
struct SeedWs {
  std::vector<std::pair<int, int>> slots;  // physical; fresh slots are {0,0}
  int M = 0;                               // logical length
  HashTaps taps;
  std::vector<int64_t> hash;
  std::vector<int64_t> sasgn;
  std::vector<Seg> segs;
  std::vector<int> order;

  inline std::pair<int, int> slot(int i) const {
    if (i < 0 || (size_t)i >= slots.size()) return {0, 0};
    return slots[i];
  }
  inline void write(int i, int b, int e) {
    if ((size_t)i >= slots.size()) slots.resize(i + 1, {0, 0});
    slots[i] = {b, e};
  }
};

static inline bool does_ovlp(int ab, int ae, int bb, int be) {
  return std::max(ab, bb) <= std::min(ae - 1, be - 1);
}

static int ws_bs(const SeedWs& w, int l, int r, int b, int e) {
  if (l > r) return -1;
  int m = (l + r) / 2;
  auto s = w.slot(m);
  if (does_ovlp(s.first, s.second, b, e)) return m;
  if (s.first < b) return ws_bs(w, m + 1, r, b, e);
  return ws_bs(w, l, m - 1, b, e);
}

static bool ws_is_contained(const SeedWs& w, int b, int e) {
  int idx = ws_bs(w, 0, w.M, b, e);
  if (idx == -1) return false;
  auto s = w.slot(idx);
  return s.first <= b && e <= s.second;
}

static void ws_add_intvl(SeedWs& w, int b, int e) {
  int idx = ws_bs(w, 0, w.M, b, e);
  if (idx == -1) {
    // reference off-by-one kept: M incremented BEFORE the write, so the
    // new interval lands one past the sorted range and the stale slot
    // M-1 is promoted instead (seed.c:163-168)
    w.M += 1;
    w.write(w.M, b, e);
    std::vector<std::pair<int, int>> head(w.M);
    for (int i = 0; i < w.M; i++) head[i] = w.slot(i);
    std::sort(head.begin(), head.end());
    for (int i = 0; i < w.M; i++) w.write(i, head[i].first, head[i].second);
    return;
  }
  int l = idx - 1;
  while (l >= 0) {
    auto s = w.slot(l);
    if (!does_ovlp(s.first, s.second, b, e)) break;
    l--;
  }
  l += 1;
  int r = idx + 1;
  while (r < w.M) {
    auto s = w.slot(r);
    if (!does_ovlp(s.first, s.second, b, e)) break;
    r++;
  }
  r -= 1;
  int nb = std::min(w.slot(l).first, b);
  int ne = std::max(w.slot(r).second, e);   // r may be M: stale read
  w.write(l, nb, ne);
  if (l == r) return;
  int d = r - l;
  w.M -= d;
  for (int i = l + 1; i < w.M; i++) {
    auto s = w.slot(i + d);
    w.write(i, s.first, s.second);
  }
}

static bool ws_covers_all(const SeedWs& w, int plen) {
  if (w.M <= 0) return false;
  auto s = w.slot(0);
  return s.first == 0 && s.second == plen;
}

template <class Valid>
static void compress(std::vector<Seg>& segs, const uint16_t* profile,
                     int plen, bool valid0, Valid valid_at) {
  segs.clear();
  int b = 0, e = 1;
  bool prev_valid = valid0;
  while (e < plen) {
    if (!prev_valid) {
      while (e < plen && !valid_at(e)) e++;
      segs.push_back({b, e, -1, -10, false});
      b = e;
      e += 1;
      prev_valid = true;
    } else {
      while (e < plen && profile[e] == profile[e - 1]) e++;
      segs.push_back({b, e, (int)profile[e - 1], 0, false});
      b = e;
      e += 1;
      prev_valid = (b < plen) ? valid_at(b) : true;
    }
  }
}

static void window_sweep(std::vector<Seg>& segs, int wsize, bool maximizer) {
  std::deque<Seg*> Q;
  auto better = [&](int a, int b) { return maximizer ? a > b : a < b; };
  bool last_oor = false;
  int last_oor_pos = 0;
  for (auto& seg : segs) {
    if (seg.cnt >= 0) {
      if (!Q.empty()) {
        Seg* first = Q.front();
        if (better(seg.cnt, first->cnt)) {
          last_oor = false;
          for (Seg* elem : Q) {
            if (first->cnt == elem->cnt)
              elem->nw = std::min(seg.b - elem->b, wsize);
            else
              elem->nw = maximizer ? elem->cnt
                                   : std::max(wsize - elem->cnt, 0);
          }
          Q.clear();
        }
      }
      while (!Q.empty() && better(seg.cnt, Q.back()->cnt)) {
        Q.back()->nw = maximizer ? Q.back()->cnt
                                 : std::max(wsize - Q.back()->cnt, 0);
        Q.pop_back();
      }
      Q.push_back(&seg);
    }
    if (Q.empty()) continue;
    while (!Q.empty() && Q.front()->b <= seg.b - wsize) {
      Seg* first = Q.front();
      first->nw = last_oor ? std::min(first->b - last_oor_pos + 1, wsize)
                           : wsize;
      if (Q.size() > 1 && (maximizer ? first->cnt > Q[1]->cnt
                                     : first->cnt < Q[1]->cnt))
        last_oor_pos = first->e;
      Q.pop_front();
      last_oor = true;
    }
  }
  while (!Q.empty()) {
    Seg* first = Q.front();
    first->nw = last_oor ? std::min(first->b - last_oor_pos + 1, wsize)
                         : wsize;
    // seed.c:321,800: drain keeps the maximizer compare in BOTH modes
    if (Q.size() > 1 && first->cnt > Q[1]->cnt) last_oor_pos = first->e;
    Q.pop_front();
    last_oor = true;
  }
}

static void mark_seg(SeedWs& w, Seg& seg, const int64_t* hash,
                     int64_t* sasgn, int wsize, int64_t mark, int plen) {
  ws_add_intvl(w, std::max(0, seg.b - wsize), std::min(seg.e + wsize, plen));
  seg.is_seed = true;
  int64_t mh = hash[seg.b];
  for (int j = seg.b + 1; j < seg.e; j++) mh = std::min(mh, hash[j]);
  for (int j = seg.b; j < seg.e; j++)
    if (hash[j] == mh) sasgn[j] = mark;
}

static void select_segs(SeedWs& w, std::vector<Seg>& segs,
                        const int64_t* hash, int64_t* sasgn, int wsize,
                        int64_t mark, int plen) {
  if (ws_covers_all(w, plen)) return;
  auto& order = w.order;
  order.resize(segs.size());
  for (size_t i = 0; i < segs.size(); i++) order[i] = (int)i;
  // stable sort by nw desc == glibc qsort order (seeds.py note)
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return segs[a].nw > segs[b].nw; });
  size_t i = 0;
  while (i < order.size()) {
    Seg& seg = segs[order[i]];
    if (seg.nw < wsize) break;
    mark_seg(w, seg, hash, sasgn, wsize, mark, plen);
    i++;
  }
  while (i < order.size()) {
    size_t ii = i;
    int nw = segs[order[i]].nw;
    while (ii < order.size() && segs[order[ii]].nw == nw) {
      Seg& s = segs[order[ii]];
      if (!ws_is_contained(w, s.b, s.e)) s.is_seed = true;
      ii++;
    }
    for (size_t jj = i; jj < ii; jj++) {
      Seg& s = segs[order[jj]];
      if (s.is_seed) mark_seg(w, s, hash, sasgn, wsize, mark, plen);
    }
    if (ws_covers_all(w, plen)) break;
    i = ii;
  }
}

static inline bool is_hd(char c) { return c == 'H' || c == 'D'; }

static int anno_repeat(int64_t* sasgn, const char* classes, int plen, int K,
                       int32_t* rep_out, int rep_cap) {
  const int MIN_UNIQ_LEN = (int)(K * 2.5);
  for (int i = 0; i < plen; i++) sasgn[i] = -10;
  int b = 0;
  bool in_R = classes[0] == 'R';
  int n_normal = is_hd(classes[0]) ? 1 : 0;
  for (int e = 1; e < plen; e++) {
    if (in_R) {
      if (classes[e] != 'R') {
        b = e;
        in_R = false;
        n_normal = is_hd(classes[e]) ? 1 : 0;
      }
    } else {
      if (classes[e] == 'R') {
        if (n_normal >= MIN_UNIQ_LEN)
          for (int i = b; i < e; i++) sasgn[i] = 0;
        in_R = true;
      } else if (is_hd(classes[e])) {
        n_normal++;
      }
    }
  }
  if (!in_R && n_normal >= MIN_UNIQ_LEN)
    for (int i = b; i < plen; i++) sasgn[i] = 0;

  int nrep = 0;
  bool r_in = sasgn[0] == -10;
  b = K - 1;
  for (int i = 1; i < plen; i++) {
    if (!r_in && sasgn[i] == -10) {
      b = i + K - 1;
      r_in = true;
    }
    if (r_in && sasgn[i] != -10) {
      if (nrep < rep_cap) {
        rep_out[2 * nrep] = b;
        rep_out[2 * nrep + 1] = i + K - 1;
      }
      nrep++;
      r_in = false;
    }
  }
  if (r_in) {
    if (nrep < rep_cap) {
      rep_out[2 * nrep] = b;
      rep_out[2 * nrep + 1] = plen + K - 1;
    }
    nrep++;
  }

  int l = BOUNDARY_UNIQ_LEN;
  while (l < plen && sasgn[l] == -10) l++;
  int r = plen - BOUNDARY_UNIQ_LEN;
  while (r >= 0 && sasgn[r] == -10) r--;
  for (int i = l; i < r; i++)
    if (sasgn[i] == -10) sasgn[i] = -11;
  return nrep;
}

}  // namespace seeds

extern "C" {

void* cp_seed_ws_new() { return new seeds::SeedWs(); }
void cp_seed_ws_free(void* w) { delete (seeds::SeedWs*)w; }

// Full find_seeds for one read (seed.c:966-1031 / seeds.py find_seeds).
// seq: read chars (plen + K - 1); classes: plen class chars (tail of the
// .class body); out: plen label chars E/H/D/R.  Returns n_rep (clamped
// writes into rep_out, 2*rep_cap int32).  Pass the SAME ws for
// consecutive reads (reference per-thread stale-slot behavior).
int cp_find_seeds(void* ws_ptr, const char* seq, const char* classes,
                  const uint16_t* profile, int plen, int K, char* out,
                  int32_t* rep_out, int rep_cap) {
  using namespace seeds;
  SeedWs& w = *(SeedWs*)ws_ptr;
  if (plen <= 0) return 0;
  if (w.taps.K != K) build_taps(w.taps, K);
  w.hash.resize(plen);
  w.sasgn.resize(plen);
  int64_t* sasgn = w.sasgn.data();
  int nrep = anno_repeat(sasgn, classes, plen, K, rep_out, rep_cap);
  kmer_hash(w.taps, seq, plen, K, w.hash.data());

  for (char C : {'H', 'D'}) {
    compress(w.segs, profile, plen, classes[0] == C,
             [&](int e) { return classes[e] == C; });
    window_sweep(w.segs, WSIZE, true);
    w.M = 0;
    for (auto& s : w.segs)
      if (s.cnt == -1) { w.write(w.M, s.b, s.e); w.M++; }
    select_segs(w, w.segs, w.hash.data(), sasgn, WSIZE, -2, plen);
  }

  compress(w.segs, profile, plen,
           sasgn[0] <= -10 && classes[0] != 'E',
           [&](int e) { return sasgn[e] <= -10 && classes[e] != 'E'; });
  window_sweep(w.segs, WSIZE_REP, false);
  w.M = 0;
  for (auto& s : w.segs)
    if (s.cnt == -1) { w.write(w.M, s.b, s.e); w.M++; }
  select_segs(w, w.segs, w.hash.data(), sasgn, WSIZE_REP, -3, plen);

  for (int i = 0; i < plen; i++)
    out[i] = sasgn[i] == -2 ? classes[i] : (sasgn[i] == -3 ? 'R' : 'E');
  return nrep;
}

}  // extern "C"

extern "C" {

// Batched profile decode: one call per chunk (the per-read Python/ctypes
// round trip dominated ProfileIndex.fetch).  Each read i decodes
// data[lo[i]:hi[i]] into out_cat[out_off[i]:out_off[i]+cap[i]]; the
// true length is written to out_n[i] (caller guarantees cap >= plen).
void cp_decode_profile_batch(const uint8_t* data, const int64_t* lo,
                             const int64_t* hi, int n,
                             uint16_t* out_cat, const int64_t* out_off,
                             const int32_t* cap, int32_t* out_n) {
  for (int i = 0; i < n; i++) {
    out_n[i] = cp_decode_profile(data + lo[i], hi[i] - lo[i],
                                 out_cat + out_off[i], cap[i]);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------
// Streaming FASTA/FASTQ reader (the role of kseq.h in the reference,
// ClassPro.c:181-188): an opaque handle on a path reads the file in
// blocks, inflates a gzip file block by block with zlib's streaming
// inflate, and hands out records chunk by chunk into the caller's
// buffers.  Its own memory is one input block and a text window that
// holds the unread part of the current record and one block more, so it
// grows with the largest record and block, never with the file.  The
// calls take no lock and start no thread: a handle is used by one
// thread at a time (the engine's prefetch thread, with the GIL released).
//
// Semantics (the port's plain reader, io/fastx._read_fastx_plain, is the
// spec): universal newlines ('\n', '\r\n' and a lone '\r' end a line
// and are not part of it); a header is its line after the mark byte,
// the name its first whitespace-delimited token, the comment the rest
// after the whitespace run that follows it (trailing bytes kept); FASTA
// sequence lines run until a line that starts with '>' and are stripped
// of all leading and trailing whitespace; a FASTQ record is exactly four
// lines (header, sequence, '+', quality), the first byte of each header
// line after the first record skipped whatever it is.  A gzip file is
// any number of members; bytes after a member that are not one fail the
// read (-2), a stream that ends early ends the text there, and a .gz
// file of fewer than 4 bytes holds no records.
// ---------------------------------------------------------------------

namespace fx {

enum Status : int64_t {
  OK = 0, FULL_SEQ = 1, FULL_NAME = 2, FULL_QUAL = 3, MORE = 4,
  NOT_FASTX = -1, BAD_GZIP = -2, TOO_LONG = -3, IO_ERROR = -4,
};

struct Reader {
  int fd = -1;
  bool gz = false;
  bool in_eof = false;       // the file is read to its end
  bool text_eof = false;     // no more text will come
  bool member_done = false;  // a gzip member ended with no input left
  bool z_live = false;
  z_stream zs;
  int64_t block = 1 << 20;
  std::vector<uint8_t> in;   // one block of the file (gzip only)
  std::vector<char> txt;     // the text window: [t0, t1) unread
  int64_t t0 = 0, t1 = 0;
  char mark = 0;             // '>' or '@' once the first byte is seen
  int64_t err = 0;           // a sticky error status
  int64_t ns_read = 0, ns_inflate = 0, ns_scan = 0;
};

static inline bool is_ws(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

// the end of the line that starts at `from` in buf[0, end): its content
// end, with *next at the line after it; -1 when the window does not show
// where the line ends (no terminator yet, or a '\r' last that a '\n'
// may follow) and more text may come
static inline int64_t line_end(const char* buf, int64_t from, int64_t end,
                               bool final, int64_t* next) {
  int64_t e = from;
  while (e < end && buf[e] != '\n' && buf[e] != '\r') {
    const void* q = std::memchr(buf + e, '\n', (size_t)(end - e));
    const int64_t lf = q ? (int64_t)((const char*)q - buf) : end;
    const void* r = std::memchr(buf + e, '\r', (size_t)(lf - e));
    e = r ? (int64_t)((const char*)r - buf) : lf;
  }
  if (e == end) {
    if (!final) return -1;
    *next = end;
    return e;
  }
  if (buf[e] == '\r') {
    if (e + 1 == end && !final) return -1;
    *next = (e + 1 < end && buf[e + 1] == '\n') ? e + 2 : e + 1;
    return e;
  }
  *next = e + 1;
  return e;
}

// append up to `block` bytes of text to the window (moving its unread
// part to the front first); false once no more text comes or on error
static bool fill(Reader& R, int64_t want) {
  if (R.text_eof || R.err) return false;
  if (R.t0 > 0) {
    std::memmove(R.txt.data(), R.txt.data() + R.t0, (size_t)(R.t1 - R.t0));
    R.t1 -= R.t0;
    R.t0 = 0;
  }
  if ((int64_t)R.txt.size() < R.t1 + want) R.txt.resize(R.t1 + want);
  char* dst = R.txt.data() + R.t1;
  const int64_t room = (int64_t)R.txt.size() - R.t1;
  if (!R.gz) {
    const long long t = now_ns();
    int64_t got = 0;
    while (got < room) {
      const ssize_t n = ::read(R.fd, dst + got, (size_t)(room - got));
      if (n < 0) { R.err = IO_ERROR; break; }
      if (n == 0) { R.in_eof = R.text_eof = true; break; }
      got += n;
    }
    R.ns_read += now_ns() - t;
    R.t1 += got;
    return got > 0;
  }
  z_stream& zs = R.zs;
  zs.next_out = reinterpret_cast<Bytef*>(dst);
  zs.avail_out = (uInt)std::min<int64_t>(room, 1 << 30);
  while (zs.avail_out > 0 && !R.text_eof) {
    if (zs.avail_in == 0 && !R.in_eof) {
      const long long t = now_ns();
      const ssize_t n = ::read(R.fd, R.in.data(), R.in.size());
      R.ns_read += now_ns() - t;
      if (n < 0) { R.err = IO_ERROR; break; }
      if (n == 0) R.in_eof = true;
      zs.next_in = R.in.data();
      zs.avail_in = (uInt)n;
    }
    if (R.member_done) {               // the next member, if bytes follow
      if (zs.avail_in == 0) { R.text_eof = true; break; }
      inflateReset2(&zs, 16 + MAX_WBITS);
      R.member_done = false;
    }
    const long long t = now_ns();
    const int rc = inflate(&zs, Z_NO_FLUSH);
    R.ns_inflate += now_ns() - t;
    if (rc == Z_STREAM_END) {
      if (zs.avail_in == 0) R.member_done = true;
      else inflateReset2(&zs, 16 + MAX_WBITS);
    } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
      R.err = BAD_GZIP;
      break;
    } else if (rc == Z_BUF_ERROR && zs.avail_in == 0 && R.in_eof) {
      R.text_eof = true;               // a stream cut short ends here
    }
  }
  const int64_t got = (int64_t)(reinterpret_cast<char*>(zs.next_out) - dst);
  R.t1 += got;
  return got > 0 || (!R.text_eof && !R.err);
}

// caller-owned chunk buffers (numpy arrays of io/fastx.ReadChunk)
struct Chunk {
  char* seq; int64_t seq_cap; int64_t* seq_off;     // [B + 1]
  char* name; int64_t name_cap; int64_t* name_off;  // [2B + 1]
  char* qual; int64_t qual_cap; int64_t* qual_off;  // [B + 1]
  int64_t* plen;                                    // [B]
};

// Scan one record at R.t0 into the chunk's record n (its offsets are
// set from the entries of record n - 1's).  Returns OK with *used the
// text it took, MORE when the window does not hold the whole record yet,
// FULL_* when a buffer lacks room (*need: the bytes it needs).
static int64_t scan(Reader& R, Chunk& C, int64_t n, int64_t* used,
                    int64_t* need) {
  const char* buf = R.txt.data();
  const int64_t end = R.t1;
  const bool final = R.text_eof;
  const int64_t pos0 = R.t0;
  int64_t nx;
  // the header: its line after the first byte (a FASTQ header line that
  // is empty has none: its terminator is not skipped)
  const bool bare = buf[pos0] == '\n' || buf[pos0] == '\r';
  const int64_t h0 = bare ? pos0 : pos0 + 1;
  const int64_t he = line_end(buf, h0, end, final, &nx);
  if (he < 0) return MORE;
  int64_t n0 = h0;
  while (n0 < he && is_ws(buf[n0])) n0++;
  int64_t n1 = n0;
  while (n1 < he && !is_ws(buf[n1])) n1++;
  int64_t c0 = n1;
  while (c0 < he && is_ws(buf[c0])) c0++;
  const int64_t c1 = c0 < he ? he : c0;
  const int64_t nm = C.name_off[2 * n];
  if (nm + (n1 - n0) + (c1 - c0) > C.name_cap) {
    *need = nm + (n1 - n0) + (c1 - c0);
    return FULL_NAME;
  }
  int64_t pos = nx;
  const int64_t s0 = C.seq_off[n];
  int64_t sp = s0;
  const auto put = [&](char* dst, int64_t cap, int64_t at, int64_t a,
                       int64_t b, int64_t* need_out) {
    if (at + (b - a) > cap) { *need_out = at + (b - a); return false; }
    std::memcpy(dst + at, buf + a, (size_t)(b - a));
    return true;
  };
  if (R.mark == '>') {
    for (;;) {
      if (pos == end) {
        if (!final) return MORE;
        break;
      }
      if (buf[pos] == '>') break;
      int64_t a = pos;
      int64_t b = line_end(buf, pos, end, final, &pos);
      if (b < 0) return MORE;
      while (a < b && is_ws(buf[a])) a++;
      while (b > a && is_ws(buf[b - 1])) b--;
      if (!put(C.seq, C.seq_cap, sp, a, b, need)) return FULL_SEQ;
      sp += b - a;
    }
  } else {
    int64_t la[3], lb[3];
    for (int part = 0; part < 3; part++) {
      int64_t a = pos;
      int64_t b = line_end(buf, pos, end, final, &pos);
      if (b < 0) return MORE;
      while (a < b && is_ws(buf[a])) a++;
      while (b > a && is_ws(buf[b - 1])) b--;
      la[part] = a;
      lb[part] = b;
    }
    if (!put(C.seq, C.seq_cap, sp, la[0], lb[0], need)) return FULL_SEQ;
    sp += lb[0] - la[0];
    const int64_t q0 = C.qual_off[n];
    if (!put(C.qual, C.qual_cap, q0, la[2], lb[2], need)) return FULL_QUAL;
    C.qual_off[n + 1] = q0 + (lb[2] - la[2]);
  }
  std::memcpy(C.name + nm, buf + n0, (size_t)(n1 - n0));
  std::memcpy(C.name + nm + (n1 - n0), buf + c0, (size_t)(c1 - c0));
  C.name_off[2 * n + 1] = nm + (n1 - n0);
  C.name_off[2 * n + 2] = nm + (n1 - n0) + (c1 - c0);
  C.seq_off[n + 1] = sp;
  *used = pos - pos0;
  return OK;
}

}  // namespace fx

extern "C" {

// Open the reader on `path` (gzip when `gz`), reading `block` bytes at a
// time; null when the file cannot be opened.
void* cp_fx_open(const char* path, int gz, int64_t block) {
  const int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  fx::Reader* R = new fx::Reader();
  R->fd = fd;
  R->gz = gz != 0;
  R->block = block > 0 ? block : (1 << 20);
  if (R->gz) {
    struct stat st;
    if (fstat(fd, &st) == 0 && st.st_size < 4) R->text_eof = true;
    std::memset(&R->zs, 0, sizeof(R->zs));
    if (inflateInit2(&R->zs, 16 + MAX_WBITS) != Z_OK) {
      R->err = fx::BAD_GZIP;
    } else {
      R->z_live = true;
      R->in.resize(R->block);
    }
  }
  return R;
}

void cp_fx_close(void* h) {
  fx::Reader* R = static_cast<fx::Reader*>(h);
  if (!R) return;
  if (R->z_live) inflateEnd(&R->zs);
  if (R->fd >= 0) ::close(R->fd);
  delete R;
}

// The bytes the reader holds (its input block and text window), and its
// seconds so far in read(2), in inflate and in the record scan.
void cp_fx_stats(void* h, int64_t* out) {
  const fx::Reader* R = static_cast<const fx::Reader*>(h);
  out[0] = (int64_t)(R->in.capacity() + R->txt.capacity());
  out[1] = R->ns_read;
  out[2] = R->ns_inflate;
  out[3] = R->ns_scan;
}

// Read records into the chunk buffers until it holds `B`, starting at
// record `n` (records [0, n) are there from an earlier call whose buffer
// ran out).  Record i: its sequence at seq[seq_off[i], seq_off[i+1]),
// name at name[name_off[2i], name_off[2i+1]), comment up to
// name_off[2i+2], FASTQ quality at qual[qual_off[i], qual_off[i+1])
// (qual_off untouched for FASTA), its profile length
// max(rlen - K + 1, 0).  Returns the record count; status[0] is OK (the
// chunk is full, or the file ended: then status[1] = 1), FULL_* (a
// buffer needs status[1] bytes: grow it and call again with the count),
// NOT_FASTX (status[1] the first byte), BAD_GZIP, IO_ERROR, or TOO_LONG
// for a record longer than max_len (status[1] its index in the chunk,
// status[3] its length; the records before it are in the chunk).
// status[2] is 1 for FASTQ once the first byte is seen.
int64_t cp_fx_next(void* h, int64_t B, int64_t n, int K, int64_t max_len,
                   char* seq, int64_t seq_cap, int64_t* seq_off,
                   char* name, int64_t name_cap, int64_t* name_off,
                   char* qual, int64_t qual_cap, int64_t* qual_off,
                   int64_t* plen, int64_t* status) {
  fx::Reader& R = *static_cast<fx::Reader*>(h);
  fx::Chunk C{seq, seq_cap, seq_off, name, name_cap, name_off,
              qual, qual_cap, qual_off, plen};
  status[0] = status[1] = status[2] = status[3] = 0;
  if (n == 0) {
    seq_off[0] = 0;
    name_off[0] = 0;
    qual_off[0] = 0;
  }
  int64_t want = R.block;
  while (n < B) {
    if (R.err) { status[0] = R.err; return n; }
    if (R.t0 == R.t1) {
      if (R.text_eof) { status[1] = 1; break; }
      fill(R, R.block);
      continue;
    }
    if (!R.mark) {
      const char c = R.txt[R.t0];
      if (c != '>' && c != '@') {
        R.err = fx::NOT_FASTX;
        status[0] = fx::NOT_FASTX;
        status[1] = (uint8_t)c;
        return n;
      }
      R.mark = c;
    }
    status[2] = R.mark == '@';
    int64_t used = 0, need = 0;
    const long long t = now_ns();
    const int64_t rc = fx::scan(R, C, n, &used, &need);
    R.ns_scan += now_ns() - t;
    if (rc == fx::MORE) {              // a record longer than the window
      if (!fill(R, want) && R.err) continue;
      want *= 2;                       // rescans stay O(log record)
      continue;
    }
    if (rc != fx::OK) {
      status[0] = rc;
      status[1] = need;
      return n;
    }
    want = R.block;
    const int64_t rlen = seq_off[n + 1] - seq_off[n];
    if (rlen > max_len) {
      R.err = fx::TOO_LONG;
      status[0] = fx::TOO_LONG;
      status[1] = n;
      status[3] = rlen;
      return n;
    }
    plen[n] = rlen - K + 1 > 0 ? rlen - K + 1 : 0;
    R.t0 += used;
    n++;
  }
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------
// The output plane: a reader chunk's .class records composed straight
// from its buffers and the class lines the finish stages wrote, for the
// writer (io.classfile.ClassWriter) to write(2) as they are.
// ---------------------------------------------------------------------

extern "C" {

// Compose the .class records of n reads into out (out_cap bytes): read
// i's are '@', its name (name[name_off[2i], name_off[2i+1])), ' ', its
// comment (up to name_off[2i+2]) or "(null)" when that is empty (glibc's
// "%s" of the reference's NULL comment), '\n', its sequence
// (seq[seq_off[i], seq_off[i+1])), "\n+\n", its class line and '\n'.
// The class line is cls_len[i] bytes at address cls_addr[i], or
// cls_len[i] 'N' where cls_addr[i] is 0 (a read with no k-mer).
// Returns 0 with res[0] the bytes written, res[1] the reads and res[2]
// the class bytes that are not 'N' (the k-mers classified); 1, writing
// nothing, when out_cap is short (res[0] the bytes needed); -1 when a
// class line's length is not its sequence's (res[3] the read).
int cp_class_compose(int64_t n, const char* name, const int64_t* name_off,
                     const char* seq, const int64_t* seq_off,
                     const int64_t* cls_addr, const int64_t* cls_len,
                     char* out, int64_t out_cap, int64_t* res) {
  static const char kNull[] = "(null)";
  res[0] = res[1] = res[2] = 0;
  res[3] = -1;
  int64_t need = 0;
  for (int64_t i = 0; i < n; i++) {
    const int64_t sl = seq_off[i + 1] - seq_off[i];
    if (cls_len[i] != sl) {
      res[3] = i;
      return -1;
    }
    const int64_t cl = name_off[2 * i + 2] - name_off[2 * i + 1];
    need += (name_off[2 * i + 1] - name_off[2 * i]) + (cl ? cl : 6)
            + 2 * sl + 7;
  }
  if (need > out_cap) {
    res[0] = need;
    return 1;
  }
  char* o = out;
  int64_t kmers = 0;
  for (int64_t i = 0; i < n; i++) {
    const int64_t n0 = name_off[2 * i], n1 = name_off[2 * i + 1],
                  n2 = name_off[2 * i + 2];
    const int64_t sl = seq_off[i + 1] - seq_off[i];
    *o++ = '@';
    std::memcpy(o, name + n0, (size_t)(n1 - n0));
    o += n1 - n0;
    *o++ = ' ';
    if (n2 > n1) {
      std::memcpy(o, name + n1, (size_t)(n2 - n1));
      o += n2 - n1;
    } else {
      std::memcpy(o, kNull, 6);
      o += 6;
    }
    *o++ = '\n';
    std::memcpy(o, seq + seq_off[i], (size_t)sl);
    o += sl;
    std::memcpy(o, "\n+\n", 3);
    o += 3;
    if (cls_addr[i]) {
      const char* c = reinterpret_cast<const char*>(cls_addr[i]);
      std::memcpy(o, c, (size_t)sl);
      int64_t k = 0;
      for (int64_t j = 0; j < sl; j++) k += c[j] != 'N';
      kmers += k;
    } else {
      std::memset(o, 'N', (size_t)sl);
    }
    o += sl;
    *o++ = '\n';
  }
  res[0] = o - out;
  res[1] = n;
  res[2] = kmers;
  return 0;
}

}  // extern "C"

// ===========================================================================
// Exact reliable-interval classifier: a bit-exact C++ port of the Python
// oracle classpro_tpu/exact/rel.py (itself a semantic port of the
// reference class_rel.c:41-963).  Used by the engine's exactness guard
// to re-decide decision-margin-flagged reads with the reference's exact
// arithmetic at native speed: the Python oracle costs ~120 ms per read,
// which made it the steady-state bottleneck of the JAX package's stream
// whenever a read carried a genuine near-tie.
// Equivalence with the oracle is pinned per-read by
// tests/test_exact_rel_native.py; any edit here must keep it green.
// ===========================================================================

namespace xrel {

constexpr int XE = 0, XR = 1, XH = 2, XD = 3, XN = 4;

struct Glob {
  int cov[4];
  double dr_ratio;
  int read_len;
  double r_logp, e_po_base, pe_mean;
  int offset;
};

// int64-safe count clamp: the oracle's _check_cnt operates on Python
// unbounded ints, so huge st counts (e.g. curr_d extrapolated from a
// large dh_ratio) must be clamped BEFORE any narrowing to int —
// narrowing first can wrap negative and turn g_logfact[...] into an
// out-of-bounds read (advisor finding, round 2).
static inline int clamp_cnt64(int64_t n) {
  return n > MAX_KMER_CNT ? MAX_KMER_CNT : (int)n;
}

// prob.c:33 semantics via numerics.logp_poisson (k clamped, k*log(lam)
// evaluated left-to-right).  lam <= 0 is the oracle's math.log(0.0)
// ValueError — callers check the num_err flag and fail loudly instead
// of silently propagating NaN/-inf (advisor finding, round 2).
static inline double x_logp_poisson64(int64_t k64, int64_t lam,
                                      bool* num_err) {
  if (lam <= 0) { *num_err = true; return NEG_INF; }
  int k = clamp_cnt64(k64);
  return k * std::log((double)lam) - lam - g_logfact[k];
}

static inline double x_logp_binom(int64_t k64, int64_t n64, double p) {
  int k = clamp_cnt64(k64);
  int n = clamp_cnt64(n64);
  return g_logfact[n] - g_logfact[k] - g_logfact[n - k] +
         k * std::log(p) + (n - k) * std::log(1 - p);
}

// util.c:35 via numerics.logp_trans; positions are int64 (they carry
// +-OFFSET excursions beyond the read).  ce-cb is kept in int64 and
// saturated into int range: beyond that the reference's own `int`
// arithmetic (util.c:35,43) is undefined, and nr_bessi at |k| ~ 2^31
// would loop for minutes in BOTH implementations — the saturated value
// keeps the C++ defined (no wrap) on inputs outside the reference's
// own domain.
// memoized exact skellam for the oracle path: nr_bessi costs
// ~2*(n+sqrt(40n)) downward-recurrence iterations per call, and one
// flagged read's fw+bw DP makes ~5k x_logp_trans calls with heavy
// (k, lam) repetition (the 4 source-state ST rows usually coincide).
// A direct-mapped cache returns the IDENTICAL bit-exact value (same
// deterministic function of (k, lam's bits), recompute on collision) —
// the guard's exact-recompute contract is unchanged.  One table serves
// every thread of the process, so the workers of cp_exact_rel_batch
// start warm and reuse what the others computed: each entry is a
// seqlock (a reader takes an entry only when its sequence is even,
// non-zero and unchanged across its loads; a writer claims it by making
// the sequence odd and leaves it to another writer that holds it).
struct SkMemo {
  std::atomic<uint32_t> seq;
  std::atomic<int32_t> k;
  std::atomic<uint64_t> lam, v;
};
static SkMemo g_sk_memo[1 << 16];

static inline double x_skellam_memo(int k, double lam) {
  constexpr size_t NB = 1 << 16;
  constexpr auto rlx = std::memory_order_relaxed;
  uint64_t lb;
  std::memcpy(&lb, &lam, 8);
  uint64_t h = (uint64_t)(uint32_t)k * 0x9E3779B97F4A7C15ULL ^
               (lb * 0xC2B2AE3D27D4EB4FULL);
  SkMemo& e = g_sk_memo[h & (NB - 1)];
  uint32_t s0 = e.seq.load(std::memory_order_acquire);
  if (s0 != 0 && !(s0 & 1)) {
    int32_t ek = e.k.load(rlx);
    uint64_t el = e.lam.load(rlx), ev = e.v.load(rlx);
    std::atomic_thread_fence(std::memory_order_acquire);
    if (e.seq.load(rlx) == s0 && ek == k && el == lb) {
      double v;
      std::memcpy(&v, &ev, 8);
      return v;
    }
  }
  double v = logp_skellam(k, lam);
  uint32_t s = e.seq.load(rlx);
  if (!(s & 1) && e.seq.compare_exchange_strong(s, s + 1, rlx)) {
    std::atomic_thread_fence(std::memory_order_release);
    uint64_t vb;
    std::memcpy(&vb, &v, 8);
    e.k.store(k, rlx);
    e.lam.store(lb, rlx);
    e.v.store(vb, rlx);
    e.seq.store(s + 2, std::memory_order_release);
  }
  return v;
}

static inline double x_logp_trans(int64_t b, int64_t e, int64_t cb,
                                  int64_t ce, int64_t cov, int read_len) {
  double lam = (double)cov * (double)std::llabs(e - b) / read_len;
  int64_t k = ce - cb;
  if (k > INT32_MAX) k = INT32_MAX;
  else if (k < -(int64_t)INT32_MAX) k = -(int64_t)INT32_MAX;
  return x_skellam_memo((int)k, lam);
}

// util.c:24 — cnt1 + (cnt2-cnt1)*(x-pos1)/(pos2-pos1), mult before div
static inline double x_lin_interp(int64_t x, int64_t pos1, int64_t cnt1,
                                  int64_t pos2, int64_t cnt2) {
  return (double)cnt1 + ((double)cnt2 - (double)cnt1) * (double)(x - pos1) /
                            (double)(pos2 - pos1);
}

struct StPair { int64_t pos, cnt; };

struct Cls {
  const Glob& G;
  int M, plen;
  bool fwd = true;
  bool num_err = false;  // oracle-mirroring loud failure (log(0)/int(inf))
  int64_t COV[4];
  std::vector<OutIntvl> iv;      // working copy (only_r entry aliasing
                                 //  = struct copy, same as the oracle's
                                 //  list-entry rebinding: entries are
                                 //  never mutated after)
  std::vector<double> dp;        // [M][4]
  std::vector<double> dh;        // [M][4] dh_ratio
  std::vector<uint8_t> rpos;     // [M]
  std::vector<int8_t> bt;        // [M][4][M]
  std::vector<StPair> st;        // [M][4][4]; ERROR slot stays zeroed

  Cls(const Glob& g, int m, int pl) : G(g), M(m), plen(pl) {}

  inline int pred(int x) const { return fwd ? x - 1 : x + 1; }
  inline int succ(int x) const { return fwd ? x + 1 : x - 1; }
  inline int64_t predp(int64_t x) const { return fwd ? x - 1 : x + 1; }
  inline int64_t offs(int64_t x) const {
    return fwd ? x - G.offset : x + G.offset;
  }
  inline int64_t beg_pos(const OutIntvl& I) const {
    return fwd ? I.b : I.e - 1;
  }
  inline int64_t beg_cnt(const OutIntvl& I) const {
    return fwd ? I.ccb : I.cce;
  }
  inline int64_t end_pos(const OutIntvl& I) const {
    return fwd ? I.e - 1 : I.b;
  }
  inline int64_t end_cnt(const OutIntvl& I) const {
    return fwd ? I.cce : I.ccb;
  }

  inline double& DP(int i, int s) { return dp[(size_t)i * 4 + s]; }
  inline double& DH(int i, int s) { return dh[(size_t)i * 4 + s]; }
  inline int8_t* BT(int i, int s) { return &bt[((size_t)i * 4 + s) * M]; }
  inline StPair& ST(int i, int s, int t) {
    return st[((size_t)i * 4 + s) * 4 + t];
  }

  // class_rel.c:113-156 D/H ratio from three alternating H/D intervals
  double calc_dh_ratio(int init_s, const int8_t* asgn, int off, int L) {
    int idx[4];
    idx[0] = fwd ? L : -1;
    int s = init_s;
    for (int i = 0; i < 3; i++) {
      int j = fwd ? idx[i] - 1 : idx[i] + 1;
      if (fwd) { while (j >= 0 && asgn[off + j] != s) j--; }
      else     { while (j < L && asgn[off + j] != s) j++; }
      idx[i + 1] = j;
      if ((fwd && j < 0) || (!fwd && j >= L)) return NEG_INF;
      s = (s == XH) ? XD : XH;
    }
    const OutIntvl& I1 = iv[off + idx[1]];
    const OutIntvl& I2 = iv[off + idx[2]];
    const OutIntvl& I3 = iv[off + idx[3]];
    int64_t s1p = beg_pos(I1), s1c = beg_cnt(I1);
    int64_t tp = end_pos(I2), tc = end_cnt(I2);
    int64_t s2p = end_pos(I3), s2c = end_cnt(I3);
    if (!fwd) { std::swap(s1p, s2p); std::swap(s1c, s2c); }
    double est = x_lin_interp(tp, s2p, s2c, s1p, s1c);
    if (init_s == XD) return est / (double)tc;
    return (double)tc / est;
  }

  // class_rel.c:158-277 emission/transition terms
  double lp_e(int i) {
    const OutIntvl& I = iv[i];
    double lp = x_logp_poisson64(I.ccb, COV[XE], &num_err) +
                x_logp_poisson64(I.cce, COV[XE], &num_err) + G.e_po_base;
    return lp < I.pe ? I.pe : lp;  // python max(): first arg wins ties
  }

  double lp_r(int i, const StPair& spr) {
    const OutIntvl& I = iv[i];
    int64_t bc = beg_cnt(I);
    double lp_er = (bc < spr.cnt)
                       ? x_logp_binom(bc, spr.cnt, 1 - G.pe_mean)
                       : NEG_INF;
    double lp = lp_er < NEG_INF ? NEG_INF : lp_er;  // max(NEG_INF, lp_er)
    if (lp > G.r_logp) return lp;
    int max_cc = I.ccb > I.cce ? I.ccb : I.cce;
    if (max_cc >= COV[XR]) return G.r_logp;
    if (max_cc >= spr.cnt) return G.r_logp;
    return lp;
  }

  double lp_h(int i, int s, const StPair* sp) {
    const OutIntvl& I = iv[i];
    int64_t bp = beg_pos(I), bc = beg_cnt(I);
    const StPair* q = &sp[XH];
    double v = x_logp_trans(predp(q->pos), bp, q->cnt, bc, q->cnt,
                            G.read_len);
    double r = DH(pred(i), s);
    if (r != NEG_INF) {
      q = &sp[XD];
      // oracle: int(r * bc) — Python raises OverflowError on inf and
      // NaN; mirror with num_err.  Finite r*bc beyond int64 can't be
      // cast (UB); saturate, x_logp_trans re-saturates into int range.
      double rv = r * (double)bc;
      int64_t rc;
      if (!std::isfinite(rv)) { num_err = true; rc = 0; }  // OverflowError
      else if (rv >= 9.2e18) rc = INT64_MAX;
      else if (rv <= -9.2e18) rc = INT64_MIN;
      else rc = (int64_t)rv;
      v = x_logp_trans(predp(q->pos), bp, q->cnt, rc, q->cnt, G.read_len);
    }
    return v + 0.0;
  }

  double lp_d(int i, int /*s*/, const StPair* sp) {
    // class_rel.c:242-270: dh_ratio branch overwritten unconditionally
    const OutIntvl& I = iv[i];
    int64_t bp = beg_pos(I), bc = beg_cnt(I);
    const StPair* q = &sp[XD];
    return x_logp_trans(predp(q->pos), bp, q->cnt, bc, q->cnt,
                        G.read_len) + 0.0;
  }

  double calc_logp(int s, int t, int i, const StPair* sp) {
    if (t == XE) return lp_e(i);
    if (t == XH) return lp_h(i, s, sp);
    if (t == XD) return lp_d(i, s, sp);
    return lp_r(i, sp[XR]);
  }

  struct MaxTr { int x; double logp; };

  MaxTr find_max_dp_tr(const double tr[4][4], int i, int s, int t) {
    int ip = pred(i);
    double maxl = NEG_INF;
    int maxx = XN;
    for (int x = 0; x < 4; x++) {
      int s_ = s < XN ? s : x;
      int t_ = t < XN ? t : x;
      double l = DP(ip, s_) + tr[s_][t_];
      if (maxl < l) { maxl = l; maxx = x; }
    }
    return {maxx, maxl};
  }

  // class_rel.c:286-513 one DP step
  void update(int i) {
    const OutIntvl& I = iv[i];
    int64_t ep = end_pos(I), ec = end_cnt(I);
    int ip = pred(i);

    double tr[4][4];
    // Per-step lp-level caches (bit-exact reuse): lp_e ignores the
    // source state entirely, and lp_r/lp_d/lp_h depend on the source
    // only through a few ST/DH fields that usually coincide across the
    // 4 states (same reason x_skellam_memo pays off) — cache the final
    // exp(lp) keyed on those exact inputs so repeated states skip the
    // poisson/binom/skellam/exp work.  Deterministic pure functions +
    // identical inputs => identical bits; num_err is sticky, so a
    // cached first call sets it exactly as repeated calls would.
    bool lpe_has = false;
    double lpe_v = 0.0;
    int nr = 0, nd = 0, nh = 0;
    int64_t r_key[4];
    int64_t d_key[4][2], h_key[4][2], h_dc[4][2];
    double h_rkey[4];
    double r_v[4], d_v[4], h_v[4];
    for (int s = 0; s < 4; s++) {
      if (DP(ip, s) == NEG_INF) {
        for (int t = 0; t < 4; t++) tr[s][t] = 0.0;
        continue;
      }
      const StPair* sp = &ST(ip, s, 0);
      for (int t = 0; t < 4; t++) {
        if (t == XE) {
          if (!lpe_has) { lpe_v = std::exp(lp_e(i)); lpe_has = true; }
          tr[s][t] = lpe_v;
        } else if (t == XR) {
          int64_t k = sp[XR].cnt;
          int j = 0;
          while (j < nr && r_key[j] != k) j++;
          if (j == nr) { r_key[nr] = k; r_v[nr++] = std::exp(lp_r(i, sp[XR])); }
          tr[s][t] = r_v[j];
        } else if (t == XD) {
          int64_t kp = sp[XD].pos, kc = sp[XD].cnt;
          int j = 0;
          while (j < nd && (d_key[j][0] != kp || d_key[j][1] != kc)) j++;
          if (j == nd) {
            d_key[nd][0] = kp; d_key[nd][1] = kc;
            d_v[nd++] = std::exp(lp_d(i, s, sp));
          }
          tr[s][t] = d_v[j];
        } else {  // XH: depends on sp[XH], DH(pred,s), and sp[XD]
          double r = DH(ip, s);
          int64_t kp = sp[XH].pos, kc = sp[XH].cnt;
          int j = 0;
          while (j < nh && (h_key[j][0] != kp || h_key[j][1] != kc ||
                            !((h_rkey[j] == r) ||
                              (std::isnan(h_rkey[j]) && std::isnan(r))) ||
                            h_dc[j][0] != sp[XD].pos ||
                            h_dc[j][1] != sp[XD].cnt))
            j++;
          if (j == nh) {
            h_key[nh][0] = kp; h_key[nh][1] = kc;
            h_rkey[nh] = r;
            h_dc[nh][0] = sp[XD].pos; h_dc[nh][1] = sp[XD].cnt;
            h_v[nh++] = std::exp(lp_h(i, s, sp));
          }
          tr[s][t] = h_v[j];
        }
      }
    }
    double psum = 0.0;
    for (int s = 0; s < 4; s++)
      for (int t = 0; t < 4; t++) psum += tr[s][t];
    if (psum == 0.0) {  // DEBUG fallback active in reference
      fprintf(stderr, "No possible state @ %d\n", i);  // class_rel.c:327
      for (int s = 0; s < 4; s++) tr[s][XE] = 1.0;
      psum = 4.0;
    }
    for (int s = 0; s < 4; s++)
      for (int t = 0; t < 4; t++)
        tr[s][t] = tr[s][t] > 0.0 ? std::log(tr[s][t] / psum) : NEG_INF;

    // all paths converge to R? (class_rel.c:348-380)
    bool only_r = true;
    for (int s = 0; s < 4; s++) {
      int maxt = find_max_dp_tr(tr, i, s, XN).x;
      if (maxt != XN && maxt != XR) { only_r = false; break; }
    }
    if (only_r) {
      rpos[i] = 1;
      iv[i] = iv[ip];
      for (int s = 0; s < 4; s++) {
        DP(i, s) = DP(ip, s);
        if (DP(i, s) == NEG_INF) continue;
        if (fwd) { if (i > 0) memcpy(BT(i, s), BT(ip, s), (size_t)i); }
        else if (i + 1 < M)
          memcpy(BT(i, s) + i + 1, BT(ip, s) + i + 1, (size_t)(M - i - 1));
        BT(i, s)[i] = (int8_t)s;
        for (int t = 0; t < 4; t++) ST(i, s, t) = ST(ip, s, t);
      }
      return;
    }

    int maxs_h = find_max_dp_tr(tr, i, XN, XH).x;
    int maxs_d = find_max_dp_tr(tr, i, XN, XD).x;
    if (maxs_h == XH && maxs_d == XD) {
      double m = tr[XD][XD] < tr[XH][XH] ? tr[XD][XD] : tr[XH][XH];
      tr[XH][XH] = tr[XD][XD] = m;
    }

    for (int t = 0; t < 4; t++) {
      MaxTr mt = find_max_dp_tr(tr, i, XN, t);
      DP(i, t) = mt.logp;
      if (mt.x == XN) continue;
      int max_s = mt.x;
      if (fwd) { if (i > 0) memcpy(BT(i, t), BT(ip, max_s), (size_t)i); }
      else if (i + 1 < M)
        memcpy(BT(i, t) + i + 1, BT(ip, max_s) + i + 1,
               (size_t)(M - i - 1));
      BT(i, t)[i] = (int8_t)t;

      if (t == XE) {
        for (int s2 = XR; s2 <= XD; s2++) ST(i, t, s2) = ST(ip, max_s, s2);
      } else if (t == XR) {
        for (int s2 = XH; s2 <= XD; s2++)
          ST(i, t, s2) = {offs(ep), ST(ip, max_s, s2).cnt};
        int64_t r_cnt = ec < COV[XR] ? ec : COV[XR];
        if (ST(ip, max_s, XR).cnt < r_cnt) ST(i, t, XR) = ST(ip, max_s, XR);
        else ST(i, t, XR) = {offs(ep), r_cnt};
      } else if (t == XH) {
        int64_t curr_h = ec, curr_d;
        int off = fwd ? 0 : i;
        int L = fwd ? i + 1 : M - i;
        double r = calc_dh_ratio(XH, BT(i, t), off, L);
        if (r == NEG_INF) {
          bool has_d = false;
          if (fwd) {
            for (int ii = 0; ii < i; ii++)
              if (BT(i, t)[ii] == XD) { has_d = true; break; }
          } else {
            for (int ii = i + 1; ii < M; ii++)
              if (BT(i, t)[ii] == XD) { has_d = true; break; }
          }
          curr_d = has_d ? ST(ip, max_s, XD).cnt : curr_h + COV[XH];
        } else {
          curr_d = (int64_t)(r * (double)curr_h);
          DH(i, t) = r;
        }
        int64_t curr_r = (int64_t)(G.dr_ratio * (double)curr_d);
        int64_t p = offs(ep);
        ST(i, t, XH) = {p, curr_h};
        ST(i, t, XD) = {p, curr_d};
        ST(i, t, XR) = {p, curr_r};
      } else {  // XD
        int64_t curr_d = ec, curr_h;
        int off = fwd ? 0 : i;
        int L = fwd ? i + 1 : M - i;
        double r = calc_dh_ratio(XD, BT(i, t), off, L);
        if (r == NEG_INF) {
          bool has_h = false;
          if (fwd) {
            for (int ii = 0; ii < i; ii++)
              if (BT(i, t)[ii] == XH) { has_h = true; break; }
          } else {
            for (int ii = i + 1; ii < M; ii++)
              if (BT(i, t)[ii] == XH) { has_h = true; break; }
          }
          if (has_h) curr_h = ST(ip, max_s, XH).cnt;
          else {
            int64_t a = curr_d / 2, b = curr_d - COV[XH];
            curr_h = a > b ? a : b;
          }
        } else {
          curr_h = (int64_t)((double)curr_d / r);
          DH(i, t) = r;
        }
        int64_t curr_r = (int64_t)(G.dr_ratio * (double)curr_d);
        int64_t p = offs(ep);
        ST(i, t, XH) = {p, curr_h};
        ST(i, t, XD) = {p, curr_d};
        ST(i, t, XR) = {p, curr_r};
      }

      // H < D < R sanity gate (class_rel.c:496-498)
      if (!(ST(i, t, XH).cnt < ST(i, t, XD).cnt &&
            ST(i, t, XD).cnt < ST(i, t, XR).cnt))
        DP(i, t) = NEG_INF;
    }
  }

  // class_rel.c:515-614 one directional pass; asgn path into path_out
  int run_pass(const OutIntvl* rintvl, int8_t* path_out) {
    num_err = false;
    dp.assign((size_t)M * 4, NEG_INF);
    dh.assign((size_t)M * 4, NEG_INF);
    rpos.assign((size_t)M, 0);
    iv.assign(rintvl, rintvl + M);
    bt.assign((size_t)M * 4 * M, 0);
    st.assign((size_t)M * 4 * 4, StPair{0, 0});

    int64_t POS_INIT = offs(fwd ? 0 : plen);
    int i = fwd ? 0 : M - 1;
    const OutIntvl& I = iv[i];
    for (int s = 0; s < 4; s++) {
      for (int t = XR; t <= XD; t++) ST(i, s, t) = {POS_INIT, COV[t]};
      BT(i, s)[i] = (int8_t)s;
    }
    DP(i, XE) = lp_e(i);
    DP(i, XR) = lp_r(i, ST(i, XR, XR));
    ST(i, XR, XR) = {end_pos(I),
                     end_cnt(I) < COV[XR] ? end_cnt(I) : COV[XR]};
    DP(i, XH) = x_logp_poisson64(beg_cnt(I), COV[XH], &num_err);
    ST(i, XH, XH) = {end_pos(I), end_cnt(I)};
    ST(i, XH, XD) = {offs(end_pos(I)), end_cnt(I) + COV[XH]};
    DP(i, XD) = x_logp_poisson64(beg_cnt(I), COV[XD], &num_err);
    {
      int64_t a = end_cnt(I) / 2, b = end_cnt(I) - COV[XH];
      ST(i, XD, XH) = {offs(end_pos(I)), a > b ? a : b};
    }
    ST(i, XD, XD) = {end_pos(I), end_cnt(I)};

    double psum = 0.0;
    for (int s = 0; s < 4; s++) psum += std::exp(DP(i, s));
    for (int s = 0; s < 4; s++) {
      double v = std::exp(DP(i, s)) / psum;
      DP(i, s) = v > 0.0 ? std::log(v) : NEG_INF;
    }

    for (;;) {
      i = succ(i);
      if ((fwd && i >= M) || (!fwd && i < 0)) break;
      update(i);
    }

    i = fwd ? M - 1 : 0;
    double maxl = NEG_INF;
    int maxs = XN;
    for (int s = 0; s < 4; s++)
      if (maxl < DP(i, s)) { maxl = DP(i, s); maxs = s; }
    if (num_err) return -2;     // oracle would have raised (log(0)/int(inf))
    if (maxs == XN) {
      // All four states dead at the final cell — reachable via the
      // psum==0 "No possible state" fallback (class_rel.c:326-331; see
      // tests/fixtures/branch/psum0).  The reference traceback then
      // reads bt[REL_IDX(i, N_STATE)], the never-written next row,
      // which is all zero bytes on a fresh workspace -> an all-ERROR
      // path (+ rpos overrides).  Mirror that (exact/rel.py does the
      // same; the reference's output here would depend on read order
      // on a dirtied workspace — ours is always the fresh-state form).
      memset(path_out, 0, (size_t)M);
      for (int j = 0; j < M; j++)
        if (rpos[j]) path_out[j] = XR;
      return 0;
    }
    memcpy(path_out, BT(i, maxs), (size_t)M);
    for (int j = 0; j < M; j++)
      if (rpos[j]) path_out[j] = XR;
    return 0;
  }

  // class_rel.c:623-845 directional wrapper with rescue heuristics
  int classify_dir(const OutIntvl* rintvl, bool f, int8_t* asgn,
                   double* hdrr_out) {
    fwd = f;
    for (int s = 0; s < 4; s++) COV[s] = G.cov[s];
    { int rc = run_pass(rintvl, asgn); if (rc < 0) return rc; }

    bool no_h = true;
    for (int i = 0; i < M; i++)
      if (asgn[i] == XH) { no_h = false; break; }
    if (no_h) {
      int64_t lsum = 0, csum = 0;
      int anchor = -1;
      for (int i = 0; i < M; i++)
        if (asgn[i] == XD) {
          int64_t l = rintvl[i].e - rintvl[i].b;
          lsum += l;
          csum += (int64_t)(rintvl[i].ccb + rintvl[i].cce) * l / 2;
          if (fwd) { if (anchor == -1) anchor = i; }
          else anchor = i;
        }
      if (anchor >= 0) {
        double mean_d = (double)csum / (double)lsum;
        if (mean_d < G.cov[XD]) {
          COV[XH] = fwd ? rintvl[anchor].ccb : rintvl[anchor].cce;
          COV[XD] = COV[XH] + G.cov[XH];
          { int rc = run_pass(rintvl, asgn); if (rc < 0) return rc; }
          no_h = true;
          for (int i = 0; i < M; i++)
            if (asgn[i] == XH) { no_h = false; break; }
          if (no_h) {
            lsum = csum = 0;
            for (int i = 0; i < M; i++)
              if (asgn[i] == XD) {
                int64_t l = rintvl[i].e - rintvl[i].b;
                lsum += l;
                csum += (int64_t)(rintvl[i].ccb + rintvl[i].cce) * l / 2;
              }
            mean_d = (double)csum / (double)lsum;
            if (std::fabs(mean_d - G.cov[XH]) <=
                std::fabs(mean_d - G.cov[XD]))
              for (int i = 0; i < M; i++)
                if (asgn[i] == XD) asgn[i] = XH;
          }
        }
      }
    }

    bool all_h = true;
    for (int i = 0; i < M; i++)
      if (asgn[i] != XH) { all_h = false; break; }
    if (all_h) {
      int64_t lsum = 0, csum = 0;
      for (int i = 0; i < M; i++) {
        int64_t l = rintvl[i].e - rintvl[i].b;
        lsum += l;
        csum += (int64_t)(rintvl[i].ccb + rintvl[i].cce) * l / 2;
      }
      double mean_h = (double)csum / (double)lsum;
      if (std::fabs(mean_h - G.cov[XH]) >= std::fabs(mean_h - G.cov[XD]))
        for (int i = 0; i < M; i++) asgn[i] = XD;
    }

    int n = 0;
    for (int i = 0; i < M; i++)
      if (asgn[i] == XH) n++;
    if ((double)n >= M * 0.7) {
      int64_t lsum = 0, csum = 0;
      for (int i = 0; i < M; i++)
        if (asgn[i] == XH) {
          int64_t l = rintvl[i].e - rintvl[i].b;
          lsum += l;
          csum += (int64_t)(rintvl[i].ccb + rintvl[i].cce) * l / 2;
        }
      double mean_h = (double)csum / (double)lsum;
      if (std::fabs(mean_h - G.cov[XH]) >= std::fabs(mean_h - G.cov[XD]))
        for (int i = 0; i < M; i++) {
          if (asgn[i] == XH) asgn[i] = XD;
          else if (asgn[i] == XD) asgn[i] = XR;
        }
    }

    int first_d = -1, last_d = -1, first_h = -1, last_h = -1;
    for (int i = 0; i < M; i++) {
      if (asgn[i] == XD) { if (first_d == -1) first_d = i; last_d = i; }
      else if (asgn[i] == XH) { if (first_h == -1) first_h = i; last_h = i; }
    }
    double hdrr = 1.0;
    if (first_d >= 0 && first_h >= 0)
      hdrr = ((double)rintvl[first_d].ccb / (double)rintvl[first_h].ccb) /
             ((double)rintvl[last_d].cce / (double)rintvl[last_h].cce);
    *hdrr_out = hdrr;
    return 0;
  }
};

// class_rel.c:847-869 (the oracle's literal transcription, including
// state values used as truthiness)
static bool is_eq_prefix(const int8_t* a, int M) {
  if (a[0] != 1) return false;
  int i = 0;
  while (i < M && a[i]) i++;
  while (i < M) {
    if (a[i]) return false;
    i++;
  }
  return true;
}

static bool is_eq_suffix(const int8_t* a, int M) {
  if (a[M - 1] != 1) return false;
  int i = M - 2;
  while (i >= 0 && a[i]) i--;
  while (i >= 0) {
    if (a[i]) return false;
    i--;
  }
  return true;
}

// classify_rel (class_rel.c:871-963) of ONE read: the is_rel records
// among recs[0, n) gathered into the caller's buffer, fw + bw +
// reconciliation, the M = (rel count) states into asgn_out.  Returns 0;
// -1 if a DP ends with all states impossible (the oracle raises there);
// -2 if the numerics hit the oracle's own loud-failure domain
// (math.log(0.0) ValueError / int(inf) OverflowError); -3 if M > cap
// (asgn_out holds cap states).  The single and the batched entry both
// run it, so they cannot drift apart.
static int exact_rel_read(const Glob& G, const OutIntvl* recs, int n,
                          int plen, std::vector<OutIntvl>& rels,
                          int8_t* asgn_out, int cap) {
  rels.clear();
  for (int k = 0; k < n; k++)
    if (recs[k].is_rel) rels.push_back(recs[k]);
  const int M = (int)rels.size();
  if (M > cap) return -3;
  if (M == 0) return 0;
  Cls C(G, M, plen);
  std::vector<int8_t> af(M), ab(M);
  double hf = 1.0, hb = 1.0;
  int rc = C.classify_dir(rels.data(), true, af.data(), &hf);
  if (rc < 0) return rc;
  rc = C.classify_dir(rels.data(), false, ab.data(), &hb);
  if (rc < 0) return rc;
  bool eq = true;
  for (int i = 0; i < M; i++)
    if (af[i] != ab[i]) { eq = false; break; }
  const int8_t* pick = af.data();
  if (!eq) {
    if (is_eq_prefix(af.data(), M)) pick = af.data();
    else if (is_eq_suffix(af.data(), M)) pick = ab.data();
    else pick = (std::fabs(hf - 1.0) <= std::fabs(hb - 1.0)) ? af.data()
                                                             : ab.data();
  }
  memcpy(asgn_out, pick, (size_t)M);
  return 0;
}

}  // namespace xrel

extern "C" {

// exact_rel_read of ONE read; rels = its contiguous rel records (is_rel
// entries only), asgn_out = M int8 states.  The return codes are
// exact_rel_read's: callers must raise on any but 0, not continue.
int cp_exact_rel(int cov_e, int cov_r, int cov_h, int cov_d,
                 double dr_ratio, int read_len, double r_logp,
                 double e_po_base, double pe_mean, int offset,
                 const OutIntvl* rels, int M, int plen,
                 int8_t* asgn_out) {
  init_logfact();
  if (M <= 0) return 0;
  xrel::Glob G{{cov_e, cov_r, cov_h, cov_d}, dr_ratio, read_len,
               r_logp, e_po_base, pe_mean, offset};
  std::vector<OutIntvl> buf;
  return xrel::exact_rel_read(G, rels, M, plen, buf, asgn_out, M);
}

// The exactness guard's re-decisions of one chunk in one call: row k
// re-decides slab read reads[k] (its records at iv[reads[k] * slot],
// n_out[reads[k]] of them) with profile length plens[k] into
// rel_out[dst[k] * max_m, + its rel count), and its return code into
// rc[k].  Rows are independent, so the bytes do not depend on threads:
// workers take rows off an atomic counter, longest read first (the DP
// grows faster than linearly in a read's intervals, so no worker is left
// with a long row at the end) on the host plane's pool, the calling
// thread one of them; all share the process's Skellam memo
// (x_skellam_memo) and keep their record buffers between calls.
void cp_exact_rel_batch(int cov_e, int cov_r, int cov_h, int cov_d,
                        double dr_ratio, int read_len, double r_logp,
                        double e_po_base, double pe_mean, int offset,
                        const OutIntvl* iv, int slot, const int* n_out,
                        int n_rows, const int* reads, const int64_t* plens,
                        const int* dst, int8_t* rel_out, int max_m,
                        int* rc, int threads) {
  init_logfact();   // not thread-safe: before any worker starts
  const xrel::Glob G{{cov_e, cov_r, cov_h, cov_d}, dr_ratio, read_len,
                     r_logp, e_po_base, pe_mean, offset};
  std::vector<int> order(n_rows);
  for (int k = 0; k < n_rows; k++) order[k] = k;
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return n_out[reads[a]] > n_out[reads[b]];
  });
  pool::parallel_rows(n_rows, threads, [&](int q) {
    thread_local std::vector<OutIntvl> buf;
    int k = order[q], i = reads[k];
    rc[k] = xrel::exact_rel_read(G, iv + (int64_t)i * slot, n_out[i],
                                 (int)plens[k], buf,
                                 rel_out + (int64_t)dst[k] * max_m, max_m);
  });
}

}  // extern "C"

// ---------------------------------------------------------------------
// A model's binomial-tail tables (classpro_tpu_torch/tables.py
// build_tables; tables._btg_row is the plain version):
//   out[(r * n_cap + n) * n_cap + k] = binom_tail(k, n, erates[r], false)
// for 1 <= n < n_cap and 0 <= k <= n, 0.0 elsewhere (row n = 0, k > n).
// A row's n + 1 terms are computed once, as logp_binom_pre orders them
// (left to right, separate products; -ffp-contract=off keeps them apart)
// but on the caller's log-factorials: numpy's LOGFACT, which _btg_row
// and the JAX package's tables read, and whose log need not be glibc's
// bit for bit (g_logfact is).  Each k then sums them in binom_tail's
// order with its early exit: from term[k] upwards when k >= n * pe, else
// 1 - (term[k-1] + term[k-2] + ...), both down to and including the term
// that trips 10 * p_curr < p_first.
// ---------------------------------------------------------------------

extern "C" {

void cp_build_btg(const double* erates, int n_rates, int n_cap,
                  const double* logfact, double* out) {
  const size_t plane = (size_t)n_cap * n_cap;
  std::memset(out, 0, sizeof(double) * plane * (size_t)n_rates);
  std::vector<double> term((size_t)n_cap);
  for (int r = 0; r < n_rates; r++) {
    const double pe = erates[r];
    const double lpe = std::log(pe), l1mpe = std::log(1 - pe);
    for (int n = 1; n < n_cap; n++) {
      double* row = out + r * plane + (size_t)n * n_cap;
      for (int x = 0; x <= n; x++)
        term[x] = std::exp(logfact[n] - logfact[x] - logfact[n - x] +
                           x * lpe + (n - x) * l1mpe);
      const double mean = n * pe;
      for (int k = 0; k <= n; k++) {
        double p, p_first;
        if ((double)k >= mean) {
          p = p_first = term[k];
          for (int x = k + 1; x <= n; x++) {
            p += term[x];
            if (10 * term[x] < p_first) break;
          }
          row[k] = p;
        } else {
          p = p_first = k == 0 ? 0.0 : term[k - 1];
          for (int x = k - 2; x >= 0; x--) {
            p += term[x];
            if (10 * term[x] < p_first) break;
          }
          row[k] = 1 - p;
        }
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------
// The all-device path's host feed (classpro_tpu_torch/pack.py holds the
// plain versions, pack_chunk and expand_asgn; the blob layout is in
// alldev.py's docstring).
//
// cp_pack_chunk fills the two transfer blobs of one read group: packed
// row t is slab read rows[t] (its records at iv[rows[t] * slot], n_out of
// them), rows t >= n_rows and rel rows j >= the group's rel reads are
// padding, and every element of both blobs is written.  A row's live
// columns are ordered by min(cb, ce), ties by column: numpy's stable
// argsort permutation (a stable order is unique), here one sort of the
// distinct keys min * 2^32 + column.  The log-factorials are the
// caller's table (numpy's LOGFACT), indexed at min(count, 32767).  Rel
// row j of the merged fw/bw planes is the j-th packed row with n_rel > 0
// (a serial prefix), its bw twin R + j the same records reversed within
// m.  Packed rows go to the workers (pool::Pool) off an atomic
// counter; each writes only its own rows, so the blobs do not depend on
// threads.  Returns 0, or for the lowest failing packed row (in
// *err_row): -1 a count below 0 where a log-factorial is read, -2 an
// n_rel different from the row's count of is_rel records, -3 a row that
// does not fit the dims.
//
// cp_expand_rows writes packed row r's class line at out_off[r]: K - 1
// 'N', then each record's e - b bytes of "ERHD"[clip(a, 0, 3)], a its
// assignment at asgn[r * stride + column].  Returns 0, or for the lowest
// failing row (in *err_row): -4 when K - 1 plus the row's e - b do not
// fill its line, -5 a record with e < b; a failing row's line is not
// written.
// ---------------------------------------------------------------------

namespace feed {

constexpr int LF_CAP = 32767;

static inline bool lf_at(const double* logfact, int n_logfact, int cnt,
                         double* out) {
  const int k = cnt > LF_CAP ? LF_CAP : cnt;
  if (k < 0 || k >= n_logfact) return false;
  *out = logfact[k];
  return true;
}

static inline int32_t minus1(int32_t v) {   // numpy's wrapping int32 - 1
  return (int32_t)((uint32_t)v - 1u);
}

static int first_error(const std::vector<int>& rc, int* err_row) {
  for (size_t t = 0; t < rc.size(); t++)
    if (rc[t]) {
      *err_row = (int)t;
      return rc[t];
    }
  *err_row = -1;
  return 0;
}

}  // namespace feed

extern "C" {

int cp_pack_chunk(const OutIntvl* iv, int slot, const int* n_out,
                  const int* n_rel, const int64_t* plens, const int* rows,
                  int n_rows, int Bn, int max_n, int R, int max_m,
                  const double* logfact, int n_logfact, int32_t* iblob,
                  double* fblob, int* err_row, int threads) {
  const size_t BN = (size_t)Bn * max_n;
  const size_t RM = (size_t)R * max_m;      // one half of a rel plane
  const size_t base = 10 * BN + Bn;
  int32_t* ip[10];
  for (int k = 0; k < 10; k++) ip[k] = iblob + k * BN;
  int32_t *pb = ip[0], *pe_ = ip[1], *pcb = ip[2], *pce = ip[3],
          *pccb = ip[4], *pcce = ip[5], *pdesc = ip[6], *pasc = ip[7],
          *pisrel = ip[8], *plive = ip[9];
  int32_t* pn = iblob + 10 * BN;
  int32_t* bpos = iblob + base;
  int32_t* bcnt = bpos + 2 * RM;
  int32_t* epos = bpos + 4 * RM;
  int32_t* ecnt = bpos + 6 * RM;
  int32_t* maxcc = bpos + 8 * RM;
  int32_t* rcols = bpos + 10 * RM;
  int32_t* pm = rcols + RM;
  int32_t* pplen = pm + 2 * R;
  int32_t* pfwd = pm + 4 * R;
  int32_t* prows = pm + 6 * R;
  double *fpe = fblob, *fpeob = fblob + BN, *fpeoe = fblob + 2 * BN,
         *flcb = fblob + 3 * BN, *flce = fblob + 4 * BN;
  double* rpe = fblob + 5 * BN;
  double* rlb = rpe + 2 * RM;
  double* rle = rpe + 4 * RM;

  const int items = std::max(Bn, R);
  std::vector<int> rc(items > 0 ? items : 1, 0);
  // rel row of each packed row (the enumeration of pack.py's rel_pos)
  std::vector<int> jrow(n_rows > 0 ? n_rows : 1, -1);
  int n_relrows = 0;
  for (int t = 0; t < n_rows; t++) {
    const int i = rows[t];
    if (n_out[i] < 0 || n_out[i] > max_n || n_rel[i] > max_m) rc[t] = -3;
    else if (n_rel[i] > 0) jrow[t] = n_relrows++;
  }
  if (n_rows > Bn || n_relrows > R) {
    *err_row = -1;
    return -3;
  }
  for (int t = 0; t < n_rows; t++)
    if (rc[t]) return feed::first_error(rc, err_row);
  double lf1;
  if (!feed::lf_at(logfact, n_logfact, 1, &lf1)) {
    *err_row = -1;
    return -1;
  }

  // a rel row pair (fw j, bw R + j) as padding from column c0 on
  auto rel_pad = [&](int j, int c0) {
    for (int h = 0; h < 2; h++) {
      const size_t o = (size_t)(h * R + j) * max_m;
      for (int c = c0; c < max_m; c++) {
        bpos[o + c] = 0; bcnt[o + c] = 1; epos[o + c] = 0;
        ecnt[o + c] = 1; maxcc[o + c] = 1;
        rpe[o + c] = NEG_INF; rlb[o + c] = lf1; rle[o + c] = lf1;
      }
    }
  };
  auto rel_head = [&](int j, int m, int32_t plen, int32_t row) {
    pm[j] = pm[R + j] = m;
    pplen[j] = pplen[R + j] = plen;
    pfwd[j] = 1;
    pfwd[R + j] = 0;
    prows[j] = row;
  };

  pool::parallel_rows(items, threads, [&](int t) {
    thread_local std::vector<int64_t> ord;
    thread_local std::vector<int> ks;
    if (ord.size() < (size_t)max_n) ord.resize(max_n);
    if (ks.size() < (size_t)max_m) ks.resize(max_m);
    if (t < R && (t >= n_relrows)) {        // padding rel rows
      rel_pad(t, 0);
      for (int c = 0; c < max_m; c++) rcols[(size_t)t * max_m + c] = max_n;
      rel_head(t, 1, 1, Bn);
    }
    if (t >= Bn) return;
    const size_t o = (size_t)t * max_n;
    int N = 0;
    if (t < n_rows) {
      const int i = rows[t];
      const OutIntvl* rec = iv + (int64_t)i * slot;
      N = n_out[i];
      int nrel = 0;
      for (int c = 0; c < N; c++) {
        const OutIntvl& r = rec[c];
        pb[o + c] = r.b; pe_[o + c] = r.e; pcb[o + c] = r.cb;
        pce[o + c] = r.ce; pccb[o + c] = r.ccb; pcce[o + c] = r.cce;
        pisrel[o + c] = r.is_rel; plive[o + c] = 1;
        fpe[o + c] = r.pe; fpeob[o + c] = r.pe_o_b; fpeoe[o + c] = r.pe_o_e;
        if (!feed::lf_at(logfact, n_logfact, r.cb, &flcb[o + c]) ||
            !feed::lf_at(logfact, n_logfact, r.ce, &flce[o + c]))
          rc[t] = -1;
        nrel += r.is_rel != 0;
      }
      // processing orders of the sweeps: live columns by min(cb, ce),
      // ties by column
      for (int c = 0; c < N; c++)
        ord[c] = (int64_t)std::min(rec[c].cb, rec[c].ce) * (INT64_C(1) << 32)
                 + c;
      std::sort(ord.begin(), ord.begin() + N);
      for (int c = 0; c < N; c++) {
        pasc[o + c] = (int32_t)(ord[c] & 0xffffffff);
        pdesc[o + c] = (int32_t)(ord[N - 1 - c] & 0xffffffff);
      }
      const int j = jrow[t];
      if (nrel != n_rel[i]) {
        if (!rc[t]) rc[t] = -2;
      } else if (j >= 0) {
        const int m = nrel;                 // ks: the row's rel columns
        for (int c = 0, w = 0; c < N; c++)
          if (rec[c].is_rel) ks[w++] = c;
        const size_t fo = (size_t)j * max_m, bo = (size_t)(R + j) * max_m;
        for (int c = 0; c < m; c++) {
          const OutIntvl& f = rec[ks[c]];           // forward column c
          const OutIntvl& v = rec[ks[m - 1 - c]];   // reversed column c
          bpos[fo + c] = f.b; bcnt[fo + c] = f.ccb;
          epos[fo + c] = feed::minus1(f.e); ecnt[fo + c] = f.cce;
          maxcc[fo + c] = std::max(f.ccb, f.cce);
          bpos[bo + c] = feed::minus1(v.e); bcnt[bo + c] = v.cce;
          epos[bo + c] = v.b; ecnt[bo + c] = v.ccb;
          maxcc[bo + c] = std::max(v.ccb, v.cce);
          rpe[fo + c] = f.pe; rpe[bo + c] = v.pe;
          rcols[fo + c] = ks[c];
          if (!feed::lf_at(logfact, n_logfact, f.ccb, &rlb[fo + c]) ||
              !feed::lf_at(logfact, n_logfact, f.cce, &rle[fo + c]) ||
              !feed::lf_at(logfact, n_logfact, v.cce, &rlb[bo + c]) ||
              !feed::lf_at(logfact, n_logfact, v.ccb, &rle[bo + c]))
            rc[t] = -1;
        }
        rel_pad(j, m);
        for (int c = m; c < max_m; c++) rcols[fo + c] = max_n;
        rel_head(j, m, (int32_t)plens[i], t);
      }
    }
    for (int c = N; c < max_n; c++) {
      pb[o + c] = 0; pe_[o + c] = 1; pcb[o + c] = 0; pce[o + c] = 0;
      pccb[o + c] = 0; pcce[o + c] = 0; pisrel[o + c] = 0; plive[o + c] = 0;
      pdesc[o + c] = 0; pasc[o + c] = 0;
      fpe[o + c] = NEG_INF; fpeob[o + c] = NEG_INF; fpeoe[o + c] = NEG_INF;
      flcb[o + c] = 0.0; flce[o + c] = 0.0;
    }
    pn[t] = N;
  });
  return feed::first_error(rc, err_row);
}

int cp_expand_rows(const OutIntvl* iv, int slot, const int* n_out,
                   const int* rows, int n_rows, const int8_t* asgn,
                   int64_t stride, int K, const int64_t* out_off, char* out,
                   int* err_row, int threads) {
  static const char stoc[4] = {'E', 'R', 'H', 'D'};
  std::vector<int> rc(n_rows > 0 ? n_rows : 1, 0);
  pool::parallel_rows(n_rows, threads, [&](int r) {
    const int i = rows[r];
    const OutIntvl* rec = iv + (int64_t)i * slot;
    const int N = n_out[i] > 0 ? n_out[i] : 0;
    const int64_t len = out_off[r + 1] - out_off[r];
    int64_t body = 0;
    for (int c = 0; c < N; c++) {
      if (rec[c].e < rec[c].b) {
        rc[r] = -5;
        return;
      }
      body += (int64_t)rec[c].e - rec[c].b;
    }
    if (K - 1 < 0 || body + K - 1 != len) {
      rc[r] = -4;
      return;
    }
    char* dst = out + out_off[r];
    memset(dst, 'N', (size_t)(K - 1));
    dst += K - 1;
    const int8_t* a = asgn + (int64_t)r * stride;
    for (int c = 0; c < N; c++) {
      int s = a[c] < 0 ? 0 : (a[c] > 3 ? 3 : a[c]);
      const size_t n = (size_t)(rec[c].e - rec[c].b);
      memset(dst, stoc[s], n);
      dst += n;
    }
  });
  return feed::first_error(rc, err_row);
}

}  // extern "C"

// ---------------------------------------------------------------------
// The main path's host rel steps after the DP (classpro_tpu_torch/rel.py
// holds the plain versions, demote_host and reconcile_fwbw; the
// reference's class_rel.c:650-713 and 847-938).
//
// cp_demote_reconcile writes the (R, max_m) forward-order assignment
// reconcile_fwbw(demote_host(v, ...)) returns, byte for byte, padding
// columns included.  v holds the DP's 2R rows (fw rows, then bw rows in
// scan order) at a row stride of v_stride bytes; rescue the 2R no-H
// rescue flags; b/e/ccb/cce the (R, max_m) forward-order planes; m the R
// live counts.  Read pair j (rows j and R + j) is one work item on the
// pool (a worker per PAIRS_PER_WORKER pairs, at most `threads`): each
// row demoted in stage order (the no-H rescue, all-H, >=70%
// H; each stage reads the previous one's result), then the pair
// reconciled into out row j.  The integer steps are numpy's int64
// arithmetic, wrapping, with floor division; the hdrr ratios IEEE f64 in
// the plain version's order.  Where a count in an hdrr ratio is 0 the
// ratio is IEEE's inf or NaN (the reference's double division, and the
// device's reconcile); the plain version raises ZeroDivisionError there.
// Returns 0, or -1 for the lowest row whose m is below 0 or above max_m
// (in *err_row; nothing is written).
// ---------------------------------------------------------------------

namespace hostrel {

// a read pair is ~1.4 us of work on the 8-core host of an H100 machine,
// and a chunk's 256 pairs ran faster on the caller alone than on eight
// workers (0.36-0.39 ms against 0.42-0.57 at T = 8; chip_smoke's host
// check): a helper joins only for each further 256 pairs
constexpr int PAIRS_PER_WORKER = 256;

constexpr int8_t REPEAT = 1, HAPLO = 2, DIPLO = 3;   // ERROR is 0

// numpy's int64 arithmetic: two's complement, wrapping
static inline int64_t wadd(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
static inline int64_t wsub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}
static inline int64_t wmul(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
static inline int64_t wabs(int64_t a) {
  return a < 0 ? (int64_t)(0 - (uint64_t)a) : a;
}
// numpy's // on int64: floor division (b > 0 here)
static inline int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q--;
  return q;
}

// a read pair's interval terms, filled at first use: l = |(e - 1) - b| +
// 1 and (bc + ec) * l // 2 of each forward column below m.  A bw row's
// column c reads forward column m - 1 - c with its two counts swapped,
// so it has the same two terms there.
struct PairTerms {
  const int32_t *b, *e, *ccb, *cce;
  int m;
  int64_t *l, *t;
  bool filled;
  void fill() {
    if (filled) return;
    for (int f = 0; f < m; f++) {
      l[f] = wabs(((int64_t)e[f] - 1) - (int64_t)b[f]) + 1;
      t[f] = floordiv(wmul((int64_t)ccb[f] + cce[f], l[f]), 2);
    }
    filled = true;
  }
};

// lsum and csum over the columns below m of a row (bw: in scan order)
// whose state is `state` (any state when state < 0)
static inline void sums(PairTerms& P, bool bw, const int8_t* a, int state,
                        int64_t* lsum, int64_t* csum) {
  P.fill();
  int64_t ls = 0, cs = 0;
  for (int c = 0; c < P.m; c++)
    if (state < 0 || a[c] == state) {
      const int f = bw ? P.m - 1 - c : c;
      ls = wadd(ls, P.l[f]);
      cs = wadd(cs, P.t[f]);
    }
  *lsum = ls;
  *csum = cs;
}

// |csum - gH * lsum| against |csum - gD * lsum|
static inline int64_t dist(int64_t csum, int64_t g, int64_t lsum) {
  return wabs(wsub(csum, wmul(g, lsum)));
}

static inline int64_t count_h(const int8_t* a, int m) {
  int64_t n = 0;
  for (int c = 0; c < m; c++) n += a[c] == HAPLO;
  return n;
}

static void demote_row(PairTerms& P, bool bw, bool rescue, int max_m,
                       int64_t gH, int64_t gD, int8_t* a) {
  const int m = P.m;
  int64_t lsum, csum;
  // no-H rescue rows: D -> H, in every column of the row
  if (rescue && count_h(a, m) == 0) {
    sums(P, bw, a, DIPLO, &lsum, &csum);
    if (lsum > 0 && dist(csum, gH, lsum) <= dist(csum, gD, lsum))
      for (int c = 0; c < max_m; c++)
        if (a[c] == DIPLO) a[c] = HAPLO;
  }
  if (m <= 0) return;      // all-H and >=70% H: a row of none is exempt
  int64_t n_h = count_h(a, m);
  // all-H rows: H -> D when the row mean sits nearer (or tied) gD
  if (n_h == m) {
    sums(P, bw, a, -1, &lsum, &csum);
    if (dist(csum, gH, lsum) >= dist(csum, gD, lsum)) {
      for (int c = 0; c < m; c++) a[c] = DIPLO;
      n_h = 0;
    }
  }
  // >=70%-H rows: H -> D and D -> R together
  if ((double)n_h >= (double)m * 0.7) {
    sums(P, bw, a, HAPLO, &lsum, &csum);
    if (lsum > 0 && dist(csum, gH, lsum) >= dist(csum, gD, lsum))
      for (int c = 0; c < m; c++)
        a[c] = a[c] == DIPLO ? REPEAT : (a[c] == HAPLO ? DIPLO : a[c]);
  }
}

// is_eq_prefix (class_rel.c:847-869) of a[0, m) read forward, or with
// rev backward; ERROR (0) is false, every other state true
static bool pref(const int8_t* a, int m, bool rev) {
  auto at = [&](int i) { return a[rev ? m - 1 - i : i]; };
  if (at(0) != REPEAT) return false;
  int i = 0;
  while (i < m && at(i)) i++;
  for (; i < m; i++)
    if (at(i)) return false;
  return true;
}

// hdrr of a forward-order row a[0, m); 1.0 without a D or an H
static double hdrr(const int8_t* a, int m, const int32_t* ccb,
                   const int32_t* cce) {
  int d0 = -1, dl = -1, h0 = -1, hl = -1;
  for (int i = 0; i < m; i++) {
    if (a[i] == DIPLO) { if (d0 < 0) d0 = i; dl = i; }
    else if (a[i] == HAPLO) { if (h0 < 0) h0 = i; hl = i; }
  }
  if (d0 < 0 || h0 < 0) return 1.0;
  return ((double)ccb[d0] / (double)ccb[h0]) /
         ((double)cce[dl] / (double)cce[hl]);
}

}  // namespace hostrel

extern "C" {

int cp_demote_reconcile(const int8_t* v, int64_t v_stride,
                        const uint8_t* rescue, const int32_t* b,
                        const int32_t* e, const int32_t* ccb,
                        const int32_t* cce, const int32_t* m, int R,
                        int max_m, int64_t gH, int64_t gD, int8_t* out,
                        int* err_row, int threads) {
  using namespace hostrel;
  *err_row = -1;
  for (int j = 0; j < R; j++)
    if (m[j] < 0 || m[j] > max_m) {
      *err_row = j;
      return -1;
    }
  pool::parallel_rows(R, threads, [&](int j) {
    thread_local std::vector<int8_t> bwrow, bwf;
    thread_local std::vector<int64_t> l, t;
    if (bwrow.size() < (size_t)max_m) {
      bwrow.resize(max_m);
      bwf.resize(max_m);
      l.resize(max_m);
      t.resize(max_m);
    }
    const size_t o = (size_t)j * max_m;
    const int mj = m[j];
    int8_t* fw = out + o;                   // the fw row, demoted in place
    std::memcpy(fw, v + j * v_stride, (size_t)max_m);
    std::memcpy(bwrow.data(), v + (R + j) * v_stride, (size_t)max_m);
    PairTerms P{b + o, e + o, ccb + o, cce + o, mj, l.data(), t.data(),
                false};
    demote_row(P, false, rescue[j] != 0, max_m, gH, gD, fw);
    demote_row(P, true, rescue[R + j] != 0, max_m, gH, gD, bwrow.data());
    // reconciliation: rows whose fw and reversed bw agree below m keep fw
    bool eq = true;
    for (int c = 0; c < mj; c++) {
      bwf[c] = bwrow[mj - 1 - c];           // bw in forward order
      eq &= fw[c] == bwf[c];
    }
    if (eq || pref(fw, mj, false)) return;
    if (!pref(fw, mj, true)) {
      const double hf = hdrr(fw, mj, ccb + o, cce + o);
      const double hb = hdrr(bwf.data(), mj, ccb + o, cce + o);
      if (std::fabs(hf - 1.0) <= std::fabs(hb - 1.0)) return;
    }
    std::memcpy(fw, bwf.data(), (size_t)mj);
  }, PAIRS_PER_WORKER);
  return 0;
}

}  // extern "C"
