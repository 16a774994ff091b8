// Dispatch-rate limiter: duty-cycle enforcement of the gpucores grant, for
// the CUDA port (the TPU library's rate_limiter.cc with a vgpu_ prefix).
//
// The reference throttles at CUDA kernel-launch granularity with a token
// bucket fed by an SM-utilization watcher (libvgpu.so symbols rate_limiter /
// utilization_watcher / get_used_gpu_utilization).  The port's Python shim
// calls us once per dispatch unit: one step callable (a train step, a
// serving prefill or decode) or one CUDA graph replay.  Model: a device
// granted `sm_limit` percent may be busy at most sm_limit/100 of wall time;
// we maintain a token bucket of *device microseconds* refilled at that
// fraction of real time and charge each dispatch its measured busy time.
//
// Priority coupling (reference feedback.go:178-219): when the node monitor
// sets utilization_switch (a higher-priority sharer is active on this device),
// low-priority processes are throttled to their grant; when the switch is
// off and the process is high-priority, dispatches pass untrottled.

#include <string.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdlib>
#include <mutex>

#include "shared_region.h"
#include "vgpu.h"

namespace {

constexpr uint64_t kDefaultCostUs = 2000;  // assume ~2ms when unknown
constexpr uint64_t kMaxBurstUs = 200000;   // bucket cap: 200ms of device time
// Latency-critical burst credit: how far tokens may go NEGATIVE.  A decode
// burst is admitted immediately against this credit and repaid from the
// class's own future refill, so over any window W the class's admitted
// device time stays <= rate*W + kMaxBurstUs + kBurstCreditUs (tokens are
// bounded in [-credit, +kMaxBurstUs]; property-tested on the TPU copy in
// test_shim.py, and tests/test_torch_shim.py holds this copy to that one).
constexpr uint64_t kBurstCreditUs = 200000;

struct Bucket {
  std::mutex mu;
  double tokens_us = kMaxBurstUs;
  uint64_t last_refill_ns = 0;
  uint64_t last_busy_us = 0;  // feedback from the previous dispatch
};

Bucket g_buckets[VGPU_MAX_DEVICES];

// Deterministic test clock (vgpu_rate_test_mode): when enabled, now_ns()
// reads a manual counter and the wait loop advances it instead of sleeping,
// making duty-cycle math exactly reproducible in tests.
std::atomic<bool> g_test_mode{false};
std::atomic<uint64_t> g_test_now_ns{0};

uint64_t now_ns() {
  if (g_test_mode.load(std::memory_order_relaxed))
    return g_test_now_ns.load(std::memory_order_relaxed);
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
}

void wait_us(uint64_t us) {
  if (g_test_mode.load(std::memory_order_relaxed))
    g_test_now_ns.fetch_add(us * 1000ull, std::memory_order_relaxed);
  else
    usleep(us);
}

// One refill-and-charge walk.  `credit_us` is how far tokens may go
// negative (0 = classic bucket; admission then requires tokens >= cost).
// With credit_us == 0 this is ARITHMETICALLY IDENTICAL to the historical
// flat loop — the flat path and the degenerate best-effort path (weight
// 100, no yield) share it, which is what makes the bit-for-bit parity pin
// in test_shim.py hold by construction.  Caller holds b.mu.
void bucket_acquire(Bucket& b, double rate, uint64_t cost_us,
                    uint64_t credit_us) {
  for (;;) {
    uint64_t now = now_ns();
    if (b.last_refill_ns == 0) b.last_refill_ns = now;
    double earned = (double)(now - b.last_refill_ns) / 1000.0 * rate;
    b.tokens_us = std::min((double)kMaxBurstUs, b.tokens_us + earned);
    b.last_refill_ns = now;
    if (b.tokens_us >= (double)cost_us - (double)credit_us) {
      b.tokens_us -= (double)cost_us;
      return;
    }
    uint64_t deficit_us = (uint64_t)(
        ((double)cost_us - (double)credit_us - b.tokens_us) / rate);
    wait_us(std::min<uint64_t>(deficit_us + 1, 50000));
  }
}

// Per-dispatch observability: wait + cost into the region so the monitor
// can compute per-class dispatch-wait p99 and the duty split without any
// in-container cooperation.  Lock-free (atomics): this sits on the
// dispatch hot path.
void qos_record(vgpu_region_t* r, uint64_t wait_us_, uint64_t cost_us) {
  __atomic_fetch_add(&r->qos_wait_count, 1ull, __ATOMIC_RELAXED);
  __atomic_fetch_add(&r->qos_wait_us_total, wait_us_, __ATOMIC_RELAXED);
  __atomic_fetch_add(&r->qos_cost_us_total, cost_us, __ATOMIC_RELAXED);
  int idx = 0;
  for (uint64_t w = wait_us_; w > 0 && idx < VGPU_QOS_WAIT_BUCKETS - 1;
       w >>= 1)
    idx++;
  __atomic_fetch_add(&r->qos_wait_hist[idx], 1ull, __ATOMIC_RELAXED);
}

}  // namespace

extern "C" {

void vgpu_rate_acquire(int dev, uint64_t cost_us) {
  vgpu_region_t* r = vgpu_region();
  if (!r || dev < 0 || dev >= VGPU_MAX_DEVICES) return;

  uint64_t sm = r->sm_limit[dev];
  // Mark activity for the monitor regardless of throttling.  SET (not
  // increment): the monitor ages this by 1 per tick, so a saturating flag
  // means "active within the last ~3 ticks" — an unbounded counter would
  // keep the priority throttle engaged for minutes after the workload went
  // idle (the reference's set_recent_kernel has the same semantics).
  __atomic_store_n(&r->recent_kernel, 3, __ATOMIC_RELAXED);

  if (sm == 0 || sm >= 100) return;  // uncapped
  // High-priority processes run free unless the monitor flipped the switch
  // policy; low-priority processes are always confined to their grant when
  // the switch is on, and run free when no high-priority sharer is active
  // (oversubscription of idle compute, reference CheckPriority).
  const char* policy = getenv("GPU_CORE_UTILIZATION_POLICY");
  bool force = policy && !strcmp(policy, "force");
  bool disable = policy && !strcmp(policy, "disable");
  if (disable) return;

  int qos = __atomic_load_n(&r->qos_class, __ATOMIC_RELAXED);
  if (qos < 0) {
    // Flat path — no vtpu.dev/qos annotation anywhere in this container.
    // Must stay byte-identical in behavior to the pre-QoS limiter
    // (parity-pinned): same gates, same bucket walk, no region recording.
    if (!force) {
      if (r->priority == 0) return;        // high priority: never throttled
      if (!r->utilization_switch) return;  // no contention: borrow idle cores
    }
    Bucket& b = g_buckets[dev];
    std::lock_guard<std::mutex> g(b.mu);
    if (cost_us == 0)
      cost_us = b.last_busy_us ? b.last_busy_us : kDefaultCostUs;
    // The bucket can never hold more than kMaxBurstUs, so an unclamped
    // larger cost (e.g. a compile measured as one dispatch) would wait
    // forever.
    if (cost_us > kMaxBurstUs) cost_us = kMaxBurstUs;
    bucket_acquire(b, (double)sm / 100.0, cost_us, 0);
    return;
  }

  // QoS-tiered path (docs/serving.md).  Effective duty share = sm_limit
  // scaled by the monitor-written per-class weight (100 = neutral; the
  // feedback loop shifts it between co-resident classes from observed
  // critical-class p99).
  //
  //  - latency-critical: always confined to its weighted share, but with a
  //    burst-credit pool — a decode burst is admitted immediately (tokens
  //    may go negative to -kBurstCreditUs) and repaid from the class's own
  //    future refill.  Priority/switch do not apply: the grant itself is
  //    the SLO contract, enforced with credit rather than on/off.
  //  - best-effort: hard duty.  With neutral weight and no yield flag this
  //    is EXACTLY the flat limiter (same gates, same arithmetic — the
  //    degenerate-parity pin).  When the monitor has shifted its weight or
  //    raised qos_yield (a co-resident critical slot has queued work), the
  //    idle-borrow bypass is closed and the bucket runs at the weighted
  //    rate.
  int weight = __atomic_load_n(&r->qos_weight_pct, __ATOMIC_RELAXED);
  if (weight <= 0) weight = 100;
  int yield_on = __atomic_load_n(&r->qos_yield, __ATOMIC_RELAXED);
  uint64_t t0 = now_ns();
  bool gated = true;
  if (qos == VGPU_QOS_BEST_EFFORT && !yield_on && weight == 100 && !force) {
    if (r->priority == 0) gated = false;             // high prio: run free
    else if (!r->utilization_switch) gated = false;  // borrow idle cores
  }
  Bucket& b = g_buckets[dev];
  {
    // Cost defaulting happens for gated AND ungated dispatches: the
    // recorded qos_cost_us_total is the duty-split observability the
    // monitor reads, and an idle-borrowing best-effort stream passing
    // cost 0 (cost unknown) must not undercount exactly the borrowing
    // being observed.
    std::lock_guard<std::mutex> g(b.mu);
    if (cost_us == 0)
      cost_us = b.last_busy_us ? b.last_busy_us : kDefaultCostUs;
    if (cost_us > kMaxBurstUs) cost_us = kMaxBurstUs;
    if (gated) {
      double rate = (double)(sm * (uint64_t)weight) / 10000.0;
      if (rate > 1.0) rate = 1.0;
      bucket_acquire(
          b, rate, cost_us,
          qos == VGPU_QOS_LATENCY_CRITICAL ? kBurstCreditUs : 0);
    }
  }
  qos_record(r, (now_ns() - t0) / 1000ull, cost_us);
}

void vgpu_rate_feedback(int dev, uint64_t busy_us) {
  if (dev < 0 || dev >= VGPU_MAX_DEVICES) return;
  Bucket& b = g_buckets[dev];
  std::lock_guard<std::mutex> g(b.mu);
  b.last_busy_us = busy_us;
}

// -- test hooks (deterministic duty-cycle verification) ----------------------

void vgpu_rate_test_mode(int on) {
  if (on) g_test_now_ns.store(1, std::memory_order_relaxed);
  g_test_mode.store(on != 0, std::memory_order_relaxed);
  if (!on) return;
  for (int i = 0; i < VGPU_MAX_DEVICES; ++i) {
    std::lock_guard<std::mutex> g(g_buckets[i].mu);
    g_buckets[i].tokens_us = kMaxBurstUs;
    g_buckets[i].last_refill_ns = 0;
    g_buckets[i].last_busy_us = 0;
  }
}

void vgpu_rate_test_advance(uint64_t ns) {
  g_test_now_ns.fetch_add(ns, std::memory_order_relaxed);
}

uint64_t vgpu_rate_test_now(void) {
  return g_test_now_ns.load(std::memory_order_relaxed);
}

}  // extern "C"
