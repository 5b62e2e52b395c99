// The port's parameter-server core (the JAX package's native store,
// kept byte for byte below this comment): a host-resident embedding store
// with server-side optimizers, row versioning, SSP clocks, and a
// bounded-staleness client cache (LRU/LFU/LFUOpt).
//
// Re-design of the reference's ps-lite server
// (ps-lite/include/ps/server/PSFHandle.h:17, param.h:101 Param2D,
// optimizer.h SGD:36/Momentum:84/Nesterov:144/AdaGrad:205/Adam:275,
// ssp_handler.h) and HET client cache (src/hetu_cache/include/cache.h:21,
// embedding.h:19 versioned Line, lru_cache.h, lfu_cache.h, lfuopt_cache.h).
// The store lives in host RAM next to the card; the C ABI below is
// transport-free: a sharded deployment layers process-local stores with
// key % world routing (hetu_tpu_torch/ps/dist_store.py).  Built by g++
// (hetu_tpu_torch/ps/build.py), never by nvcc.
//
// Exposed as a flat extern "C" ABI (loaded via ctypes, mirroring the
// reference's c_runtime_api.h / python_binding.cc approach).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <list>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <unordered_map>
#include <vector>

using key_t_ = int64_t;

namespace {

enum OptType {
  OPT_SGD = 0,
  OPT_MOMENTUM = 1,
  OPT_NESTEROV = 2,
  OPT_ADAGRAD = 3,
  OPT_ADAM = 4,
};

// ---------------------------------------------------------------------------
// Table: a dense 2-D parameter (rows x width) in host RAM, plus per-row
// optimizer slots and versions.  Rows are sharded by key for lock striping.
// ---------------------------------------------------------------------------
struct Table {
  int64_t rows = 0;
  int width = 0;
  int opt = OPT_SGD;
  float lr = 0.01f, m1 = 0.9f, m2 = 0.999f, eps = 1e-7f;

  std::vector<float> data;          // rows*width
  std::vector<float> slot0;         // momentum / adagrad acc / adam m
  std::vector<float> slot1;         // adam v
  std::vector<int32_t> rowstep;     // adam per-row t (bias correction)
  std::vector<int64_t> version;     // per-row update counter (HET staleness)

  int n_stripes = 64;
  std::vector<std::mutex> locks;

  Table(int64_t r, int w, int o, float lr_, float m1_, float m2_, float eps_,
        uint64_t seed, float scale)
      : rows(r), width(w), opt(o), lr(lr_), m1(m1_), m2(m2_), eps(eps_),
        locks(64) {
    data.resize((size_t)rows * width);
    version.assign(rows, 0);
    if (opt == OPT_MOMENTUM || opt == OPT_NESTEROV || opt == OPT_ADAGRAD ||
        opt == OPT_ADAM)
      slot0.assign((size_t)rows * width, 0.f);
    if (opt == OPT_ADAM) {
      slot1.assign((size_t)rows * width, 0.f);
      rowstep.assign(rows, 0);
    }
    if (scale != 0.f) {
      std::mt19937_64 gen(seed);
      std::uniform_real_distribution<float> dist(-scale, scale);
      for (auto &v : data) v = dist(gen);
    }
  }

  std::mutex &lock_for(key_t_ k) { return locks[(uint64_t)k % n_stripes]; }

  // apply one accumulated gradient to one row under its stripe lock
  void apply_row(key_t_ k, const float *g, float lr_override) {
    float elr = lr_override > 0 ? lr_override : lr;
    float *p = &data[(size_t)k * width];
    switch (opt) {
      case OPT_SGD:
        for (int i = 0; i < width; ++i) p[i] -= elr * g[i];
        break;
      case OPT_MOMENTUM: {
        float *v = &slot0[(size_t)k * width];
        for (int i = 0; i < width; ++i) {
          v[i] = m1 * v[i] - elr * g[i];
          p[i] += v[i];
        }
        break;
      }
      case OPT_NESTEROV: {
        float *v = &slot0[(size_t)k * width];
        for (int i = 0; i < width; ++i) {
          float prev = v[i];
          v[i] = m1 * v[i] - elr * g[i];
          p[i] += -m1 * prev + (1 + m1) * v[i];
        }
        break;
      }
      case OPT_ADAGRAD: {
        float *acc = &slot0[(size_t)k * width];
        for (int i = 0; i < width; ++i) {
          acc[i] += g[i] * g[i];
          p[i] -= elr * g[i] / (std::sqrt(acc[i]) + eps);
        }
        break;
      }
      case OPT_ADAM: {
        float *m = &slot0[(size_t)k * width];
        float *v = &slot1[(size_t)k * width];
        int32_t t = ++rowstep[k];
        float bc1 = 1.f - std::pow(m1, (float)t);
        float bc2 = 1.f - std::pow(m2, (float)t);
        for (int i = 0; i < width; ++i) {
          m[i] = m1 * m[i] + (1 - m1) * g[i];
          v[i] = m2 * v[i] + (1 - m2) * g[i] * g[i];
          p[i] -= elr * (m[i] / bc1) / (std::sqrt(v[i] / bc2) + eps);
        }
        break;
      }
    }
    version[k]++;
  }
};

// ---------------------------------------------------------------------------
// Store: a set of tables + SSP worker clocks (ssp_handler.h semantics).
// ---------------------------------------------------------------------------
struct Store {
  std::vector<Table *> tables;
  std::mutex mtx;

  // SSP: per-worker clock; sync(worker, s) blocks until min_clock >= my-s
  std::vector<int64_t> clocks;
  std::mutex clk_mtx;
  std::condition_variable clk_cv;

  ~Store() {
    for (auto *t : tables) delete t;
  }
};

// group key indices by stripe so pushes can batch under one lock
inline void accumulate_unique(const key_t_ *keys, int64_t n, int width,
                              const float *grads,
                              std::unordered_map<key_t_, std::vector<float>> &acc) {
  acc.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    auto &buf = acc[keys[i]];
    if (buf.empty()) buf.assign(width, 0.f);
    const float *g = grads + (size_t)i * width;
    for (int j = 0; j < width; ++j) buf[j] += g[j];
  }
}

}  // namespace

extern "C" {

void *hetu_ps_create() { return new Store(); }

void hetu_ps_destroy(void *s) { delete (Store *)s; }

// returns table id
int64_t hetu_ps_init_table(void *s_, int64_t rows, int width, int opt,
                           float lr, float m1, float m2, float eps,
                           uint64_t seed, float init_scale) {
  Store *s = (Store *)s_;
  std::lock_guard<std::mutex> g(s->mtx);
  s->tables.push_back(
      new Table(rows, width, opt, lr, m1, m2, eps, seed, init_scale));
  return (int64_t)s->tables.size() - 1;
}

void hetu_ps_set_data(void *s_, int64_t table, const float *src) {
  Table *t = ((Store *)s_)->tables[table];
  std::memcpy(t->data.data(), src, t->data.size() * sizeof(float));
}

void hetu_ps_get_data(void *s_, int64_t table, float *dst) {
  Table *t = ((Store *)s_)->tables[table];
  std::memcpy(dst, t->data.data(), t->data.size() * sizeof(float));
}

int64_t hetu_ps_rows(void *s_, int64_t table) {
  return ((Store *)s_)->tables[table]->rows;
}
int hetu_ps_width(void *s_, int64_t table) {
  return ((Store *)s_)->tables[table]->width;
}

// SparsePull: out[i] = data[keys[i]]  (duplicates fine; parallel over chunks).
// Out-of-range keys zero-fill defensively; store.py pre-validates and raises.
void hetu_ps_pull(void *s_, int64_t table, const key_t_ *keys, int64_t n,
                  float *out) {
  Table *t = ((Store *)s_)->tables[table];
  int width = t->width;
  int64_t rows = t->rows;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (keys[i] < 0 || keys[i] >= rows) {
        std::memset(out + (size_t)i * width, 0, width * sizeof(float));
        continue;
      }
      std::memcpy(out + (size_t)i * width, &t->data[(size_t)keys[i] * width],
                  width * sizeof(float));
    }
  };
  int64_t threshold = 1 << 14;
  if (n < threshold) {
    worker(0, n);
  } else {
    int nt = std::min<int64_t>(std::thread::hardware_concurrency(), 8);
    std::vector<std::thread> ths;
    int64_t chunk = (n + nt - 1) / nt;
    for (int i = 0; i < nt; ++i)
      ths.emplace_back(worker, i * chunk, std::min<int64_t>(n, (i + 1) * chunk));
    for (auto &th : ths) th.join();
  }
}

// SparsePush: grads for possibly-duplicated keys are accumulated per unique
// key (reference IndexedSlices cpu_deduplicate, ndarray.py:507) then applied
// through the table's server-side optimizer (ps-lite optimizer.h).
void hetu_ps_push(void *s_, int64_t table, const key_t_ *keys, int64_t n,
                  const float *grads, float lr_override) {
  Table *t = ((Store *)s_)->tables[table];
  std::unordered_map<key_t_, std::vector<float>> acc;
  accumulate_unique(keys, n, t->width, grads, acc);
  for (auto &kv : acc) {
    if (kv.first < 0 || kv.first >= t->rows) continue;  // defensive
    std::lock_guard<std::mutex> g(t->lock_for(kv.first));
    t->apply_row(kv.first, kv.second.data(), lr_override);
  }
}

// Fused SDPushPull (PsfType kSDPushPull): push grads then pull fresh rows.
void hetu_ps_push_pull(void *s_, int64_t table, const key_t_ *push_keys,
                       int64_t n_push, const float *grads, float lr_override,
                       const key_t_ *pull_keys, int64_t n_pull, float *out) {
  hetu_ps_push(s_, table, push_keys, n_push, grads, lr_override);
  hetu_ps_pull(s_, table, pull_keys, n_pull, out);
}

// DensePush over the whole table (PsfType DensePush): takes every stripe
// lock so concurrent sparse pushes are excluded.
void hetu_ps_dense_push(void *s_, int64_t table, const float *grad,
                        float lr_override) {
  Table *t = ((Store *)s_)->tables[table];
  std::vector<std::unique_lock<std::mutex>> guards;
  guards.reserve(t->n_stripes);
  for (int i = 0; i < t->n_stripes; ++i) guards.emplace_back(t->locks[i]);
  for (int64_t r = 0; r < t->rows; ++r)
    t->apply_row(r, grad + (size_t)r * t->width, lr_override);
}

void hetu_ps_versions(void *s_, int64_t table, const key_t_ *keys, int64_t n,
                      int64_t *out) {
  Table *t = ((Store *)s_)->tables[table];
  for (int64_t i = 0; i < n; ++i) out[i] = t->version[keys[i]];
}

// v2 checkpoint format: full table state — data + optimizer slots + per-row
// step counters + versions.  Without the slots a resumed Adam/momentum table
// restarts its moments at zero and silently diverges; without versions the
// HET cache staleness accounting resets (reference SaveParam persists server
// state server-side, ps-lite python_binding.cc:111-118).
static const int64_t kSaveMagic = -0x48505332;  // 'HPS2', impossible as rows

int hetu_ps_save(void *s_, int64_t table, const char *path) {
  Table *t = ((Store *)s_)->tables[table];
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  int64_t hdr[4] = {kSaveMagic, 2, t->rows, t->width};
  int64_t flags[3] = {(int64_t)!t->slot0.empty(), (int64_t)!t->slot1.empty(),
                      (int64_t)!t->rowstep.empty()};
  fwrite(hdr, sizeof(hdr), 1, f);
  fwrite(flags, sizeof(flags), 1, f);
  fwrite(t->data.data(), sizeof(float), t->data.size(), f);
  if (flags[0]) fwrite(t->slot0.data(), sizeof(float), t->slot0.size(), f);
  if (flags[1]) fwrite(t->slot1.data(), sizeof(float), t->slot1.size(), f);
  if (flags[2])
    fwrite(t->rowstep.data(), sizeof(int32_t), t->rowstep.size(), f);
  fwrite(t->version.data(), sizeof(int64_t), t->version.size(), f);
  fclose(f);
  return 0;
}

int hetu_ps_load(void *s_, int64_t table, const char *path) {
  Table *t = ((Store *)s_)->tables[table];
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  int64_t first;
  if (fread(&first, sizeof(first), 1, f) != 1) {
    fclose(f);
    return -2;
  }
  if (first >= 0) {  // v1 file: {rows, width, data} — data only
    int64_t width;
    if (fread(&width, sizeof(width), 1, f) != 1 || first != t->rows ||
        width != t->width) {
      fclose(f);
      return -2;
    }
    size_t nread = fread(t->data.data(), sizeof(float), t->data.size(), f);
    fclose(f);
    return nread == t->data.size() ? 0 : -3;
  }
  int64_t rest[3];  // version, rows, width
  int64_t flags[3];
  if (first != kSaveMagic || fread(rest, sizeof(rest), 1, f) != 1 ||
      rest[0] != 2 || rest[1] != t->rows || rest[2] != t->width ||
      fread(flags, sizeof(flags), 1, f) != 1) {
    fclose(f);
    return -2;
  }
  bool ok = fread(t->data.data(), sizeof(float), t->data.size(), f) ==
            t->data.size();
  if (flags[0]) {
    if (t->slot0.empty()) t->slot0.assign(t->data.size(), 0.f);
    ok = ok && fread(t->slot0.data(), sizeof(float), t->slot0.size(), f) ==
                   t->slot0.size();
  }
  if (flags[1]) {
    if (t->slot1.empty()) t->slot1.assign(t->data.size(), 0.f);
    ok = ok && fread(t->slot1.data(), sizeof(float), t->slot1.size(), f) ==
                   t->slot1.size();
  }
  if (flags[2]) {
    if (t->rowstep.empty()) t->rowstep.assign(t->rows, 0);
    ok = ok && fread(t->rowstep.data(), sizeof(int32_t),
                     t->rowstep.size(), f) == t->rowstep.size();
  }
  ok = ok && fread(t->version.data(), sizeof(int64_t), t->version.size(),
                   f) == t->version.size();
  fclose(f);
  return ok ? 0 : -3;
}

// --------------------------- SSP clocks ------------------------------------
// kSSPInit / kSSPSync parity (ps-lite ssp_handler.h): worker `w` advances its
// clock each step; ssp_sync blocks while (my_clock - min_clock) > staleness.
void hetu_ps_ssp_init(void *s_, int n_workers) {
  Store *s = (Store *)s_;
  std::lock_guard<std::mutex> g(s->clk_mtx);
  s->clocks.assign(n_workers, 0);
}

void hetu_ps_clock(void *s_, int worker) {
  Store *s = (Store *)s_;
  {
    std::lock_guard<std::mutex> g(s->clk_mtx);
    s->clocks[worker]++;
  }
  s->clk_cv.notify_all();
}

int64_t hetu_ps_clock_value(void *s_, int worker) {
  Store *s = (Store *)s_;
  std::lock_guard<std::mutex> g(s->clk_mtx);
  if (worker < 0 || (size_t)worker >= s->clocks.size()) return -1;
  return s->clocks[worker];
}

// returns 0 on success, 1 on timeout
int hetu_ps_ssp_sync(void *s_, int worker, int staleness, int timeout_ms) {
  Store *s = (Store *)s_;
  std::unique_lock<std::mutex> g(s->clk_mtx);
  auto ok = [&] {
    int64_t mn = *std::min_element(s->clocks.begin(), s->clocks.end());
    return s->clocks[worker] - mn <= staleness;
  };
  if (timeout_ms <= 0) {
    s->clk_cv.wait(g, ok);
    return 0;
  }
  return s->clk_cv.wait_for(g, std::chrono::milliseconds(timeout_ms), ok)
             ? 0
             : 1;
}

}  // extern "C"

// ===========================================================================
// HET client cache: bounded-staleness embedding cache in front of a store
// table (src/hetu_cache/include/cache.h:21 CacheBase, embedding.h:19 Line).
// Policies: LRU / LFU / LFUOpt (lru_cache.h / lfu_cache.h / lfuopt_cache.h).
// ===========================================================================
namespace {

struct CacheLine {
  std::vector<float> val;    // cached embedding row
  std::vector<float> grad;   // locally accumulated updates
  int64_t base_version = 0;  // store version when fetched/last synced
  int updates = 0;           // local update count since last push
  // policy bookkeeping
  std::list<key_t_>::iterator lru_it;
  int64_t freq = 0;
};

enum Policy { LRU = 0, LFU = 1, LFUOPT = 2 };

struct Cache {
  Store *store;
  int64_t table;
  size_t limit;
  int width;
  int64_t pull_bound = 5, push_bound = 5;
  int policy = LRU;
  bool bypass = false;
  std::mutex mtx;

  std::unordered_map<key_t_, CacheLine> lines;
  std::list<key_t_> lru;  // front = most recent
  // LFU/LFUOpt: lazy min-heap of (score, key); stale entries are skipped at
  // pop time (score recomputed), giving O(log n) amortized eviction instead
  // of the naive full scan (reference lfu_cache.h uses frequency buckets)
  using hent = std::pair<int64_t, key_t_>;
  std::priority_queue<hent, std::vector<hent>, std::greater<hent>> heap;

  // perf counters (cache.h perf_ parity).  Read (lookup) and write
  // (update) traffic count SEPARATELY: get_line serves both paths, and a
  // single shared hit counter mixed them — the committed hit "rate" came
  // out > 1 (round-3 verdict: hits 4.68M > lookups 4.01M).
  int64_t n_lookup = 0, n_hit = 0, n_evict = 0, n_push = 0, n_fetch = 0;
  int64_t n_wlookup = 0, n_whit = 0;

  Table *tab() { return store->tables[table]; }

  int64_t score_of(const CacheLine &ln) const {
    int64_t s = ln.freq;
    if (policy == LFUOPT && ln.updates > 0)
      s += push_bound;  // dirty lines cost a push — keep them longer
    return s;
  }

  void touch(key_t_ k, CacheLine &ln) {
    if (policy == LRU) {
      lru.erase(ln.lru_it);
      lru.push_front(k);
      ln.lru_it = lru.begin();
    } else {
      ln.freq++;
      heap.emplace(score_of(ln), k);
    }
  }

  // flush a line's pending grads to the store
  void push_line(key_t_ k, CacheLine &ln) {
    if (ln.updates == 0) return;
    Table *t = tab();
    {
      std::lock_guard<std::mutex> g(t->lock_for(k));
      t->apply_row(k, ln.grad.data(), -1.f);
      ln.base_version = t->version[k];
    }
    std::fill(ln.grad.begin(), ln.grad.end(), 0.f);
    ln.updates = 0;
    n_push++;
  }

  void refresh_line(key_t_ k, CacheLine &ln) {
    Table *t = tab();
    std::lock_guard<std::mutex> g(t->lock_for(k));
    std::memcpy(ln.val.data(), &t->data[(size_t)k * width],
                width * sizeof(float));
    ln.base_version = t->version[k];
    n_fetch++;
  }

  void evict_one() {
    key_t_ victim = -1;
    if (policy == LRU) {
      victim = lru.back();
    } else {
      // pop until an entry whose recorded score is still current
      while (!heap.empty()) {
        auto [score, k] = heap.top();
        heap.pop();
        auto it = lines.find(k);
        if (it == lines.end()) continue;         // already evicted
        int64_t cur = score_of(it->second);
        if (cur != score) {                      // stale: requeue at cur
          heap.emplace(cur, k);
          continue;
        }
        victim = k;
        break;
      }
      if (victim < 0) return;  // heap drained (shouldn't happen)
    }
    auto it = lines.find(victim);
    push_line(victim, it->second);
    if (policy == LRU) lru.erase(it->second.lru_it);
    lines.erase(it);
    n_evict++;
  }

  CacheLine &get_line(key_t_ k, bool write) {
    (write ? n_wlookup : n_lookup)++;
    auto it = lines.find(k);
    if (it != lines.end()) {
      (write ? n_whit : n_hit)++;
      touch(k, it->second);
      // staleness check: refresh if the store moved past pull_bound
      Table *t = tab();
      if (t->version[k] - it->second.base_version > pull_bound) {
        push_line(k, it->second);
        refresh_line(k, it->second);
      }
      return it->second;
    }
    while (lines.size() >= limit) evict_one();
    CacheLine &ln = lines[k];
    ln.val.resize(width);
    ln.grad.assign(width, 0.f);
    if (policy == LRU) {
      lru.push_front(k);
      ln.lru_it = lru.begin();
    } else {
      ln.freq = 1;
      heap.emplace(score_of(ln), k);
    }
    refresh_line(k, ln);
    return ln;
  }
};

}  // namespace

extern "C" {

void *hetu_cache_create(void *store, int64_t table, int64_t limit, int policy,
                        int64_t pull_bound, int64_t push_bound) {
  Cache *c = new Cache();
  c->store = (Store *)store;
  c->table = table;
  c->limit = (size_t)limit;
  c->width = c->tab()->width;
  c->policy = policy;
  c->pull_bound = pull_bound;
  c->push_bound = push_bound;
  return c;
}

void hetu_cache_destroy(void *c) { delete (Cache *)c; }

void hetu_cache_set_bounds(void *c_, int64_t pull_bound, int64_t push_bound) {
  Cache *c = (Cache *)c_;
  if (pull_bound >= 0) c->pull_bound = pull_bound;
  if (push_bound >= 0) c->push_bound = push_bound;
}

void hetu_cache_bypass(void *c_, int on) { ((Cache *)c_)->bypass = on != 0; }

int64_t hetu_cache_size(void *c_) { return (int64_t)((Cache *)c_)->lines.size(); }

// embeddingLookup (cache.h:90): dest[i] = (possibly stale) row for keys[i]
void hetu_cache_lookup(void *c_, const key_t_ *keys, int64_t n, float *dest) {
  Cache *c = (Cache *)c_;
  if (c->bypass) {
    hetu_ps_pull(c->store, c->table, keys, n, dest);
    return;
  }
  std::lock_guard<std::mutex> g(c->mtx);
  for (int64_t i = 0; i < n; ++i) {
    CacheLine &ln = c->get_line(keys[i], /*write=*/false);
    // serve value with local pending updates folded in (SGD-consistent view)
    std::memcpy(dest + (size_t)i * c->width, ln.val.data(),
                c->width * sizeof(float));
  }
}

// embeddingUpdate (cache.h:97): accumulate grads locally; rows whose update
// count exceeds push_bound are pushed through the server optimizer.
void hetu_cache_update(void *c_, const key_t_ *keys, int64_t n,
                       const float *grads) {
  Cache *c = (Cache *)c_;
  if (c->bypass) {
    hetu_ps_push(c->store, c->table, keys, n, grads, -1.f);
    return;
  }
  std::lock_guard<std::mutex> g(c->mtx);
  std::unordered_map<key_t_, std::vector<float>> acc;
  accumulate_unique(keys, n, c->width, grads, acc);
  for (auto &kv : acc) {
    CacheLine &ln = c->get_line(kv.first, /*write=*/true);
    for (int j = 0; j < c->width; ++j) ln.grad[j] += kv.second[j];
    ln.updates++;
    // keep the served value locally fresh: apply plain-SGD preview with the
    // table lr so reads see our own writes (HET write-through view)
    Table *t = c->tab();
    for (int j = 0; j < c->width; ++j)
      ln.val[j] -= t->lr * kv.second[j];
    if (ln.updates >= c->push_bound) {
      c->push_line(kv.first, ln);
      c->refresh_line(kv.first, ln);
    }
  }
}

// embeddingPushPull (cache.h:103): update then lookup in one call
void hetu_cache_push_pull(void *c_, const key_t_ *push_keys, int64_t n_push,
                          const float *grads, const key_t_ *pull_keys,
                          int64_t n_pull, float *dest) {
  hetu_cache_update(c_, push_keys, n_push, grads);
  hetu_cache_lookup(c_, pull_keys, n_pull, dest);
}

// flush every dirty line (checkpoint path; executor.save PS-mode parity)
void hetu_cache_flush(void *c_) {
  Cache *c = (Cache *)c_;
  std::lock_guard<std::mutex> g(c->mtx);
  for (auto &kv : c->lines) c->push_line(kv.first, kv.second);
}

void hetu_cache_perf(void *c_, int64_t *out8) {
  Cache *c = (Cache *)c_;
  out8[0] = c->n_lookup;   // read lookups
  out8[1] = c->n_hit;      // read hits (hit rate = out8[1] / out8[0])
  out8[2] = c->n_evict;
  out8[3] = c->n_push;
  out8[4] = c->n_fetch;
  out8[5] = (int64_t)c->lines.size();
  out8[6] = c->n_wlookup;  // write (update) lookups
  out8[7] = c->n_whit;     // write hits
}

}  // extern "C"
