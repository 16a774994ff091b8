/* vgpu shared accounting region — the ABI between the in-container
 * enforcement library and the node monitor, for the CUDA port.
 *
 * The port's own copy of the JAX package's region (same struct, same
 * sizes, same offsets, same magic).  The node monitor is shared by both
 * packages, so a region the port writes must read exactly like one the
 * TPU library writes: the magic still spells "VTPU", the ABI version is 1,
 * and the static_asserts below pin every offset.  Only the names of the
 * types, macros and exported functions differ (a `vgpu_` prefix), so one
 * process can load both libraries without confusing their symbols.
 *
 * One region file exists per pod-container, at
 * $CUDA_DEVICE_MEMORY_SHARED_CACHE; every CUDA process in the container
 * mmaps it, the node monitor mmaps all of them from the host side.  The
 * cross-process lock is a pthread robust mutex (dead-owner recovery by
 * EOWNERDEAD), all sizes are bytes, all fields fixed-width.
 */
#ifndef VGPU_SHARED_REGION_H_
#define VGPU_SHARED_REGION_H_

#include <pthread.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define VGPU_MAGIC 0x56545055u /* "VTPU": the monitor's magic, kept */
#define VGPU_ABI_VERSION 1
#define VGPU_MAX_DEVICES 16
#define VGPU_MAX_PROCS 1024
#define VGPU_UUID_LEN 64

/* QoS classes (VTPU_QOS_CLASS env).  VGPU_QOS_OFF keeps the flat limiter
 * path bit for bit. */
#define VGPU_QOS_OFF (-1)
#define VGPU_QOS_BEST_EFFORT 0
#define VGPU_QOS_LATENCY_CRITICAL 1
/* Dispatch-wait histogram: log2 microsecond buckets.  Bucket 0 counts
 * zero-wait admissions; bucket k>=1 covers [2^(k-1), 2^k) us; the last
 * bucket saturates. */
#define VGPU_QOS_WAIT_BUCKETS 20

/* Per-process accounting slot. */
typedef struct {
  int32_t pid;     /* in-container pid; 0 = slot free */
  int32_t hostpid; /* filled by the monitor (cgroup walk) */
  int32_t status;  /* 1 = alive, 2 = exited-unclean (monitor GC) */
  int32_t pidns;   /* truncated /proc/self/ns/pid inode of the writer;
                    * 0 = unknown.  Lets an in-container attacher reap dead
                    * same-namespace slots. */
  uint64_t used[VGPU_MAX_DEVICES];         /* bytes, self-reported */
  uint64_t monitor_used[VGPU_MAX_DEVICES]; /* bytes, monitor-measured */
} vgpu_proc_slot_t;

typedef struct {
  uint32_t magic;
  int32_t abi_version;
  int32_t initialized; /* 1 once the creating process finished init */
  int32_t num_devices;
  int64_t owner_pid; /* creator, informational */
  uint64_t generation;

  pthread_mutex_t lock; /* PROCESS_SHARED | ROBUST */

  char uuids[VGPU_MAX_DEVICES][VGPU_UUID_LEN];
  uint64_t limit[VGPU_MAX_DEVICES];    /* device-memory cap, bytes; 0 = uncapped */
  uint64_t sm_limit[VGPU_MAX_DEVICES]; /* compute cap, percent (0/100 = uncapped) */

  /* Monitor feedback plane: the monitor turns utilization_switch on when a
   * higher-priority sharer is active on the same physical device; the rate
   * limiter then throttles low-priority processes.  recent_kernel is set on
   * every dispatch and aged by the monitor to detect activity. */
  int32_t utilization_switch;
  int32_t recent_kernel;
  int32_t priority; /* 0 = high, 1 = low */
  int32_t oversubscribe;

  int32_t proc_num; /* high-water mark of used slots */
  int32_t pad2_;
  vgpu_proc_slot_t procs[VGPU_MAX_PROCS];

  /* QoS plane, appended after procs so every earlier field keeps its
   * offset.  qos_class is set once at init from VTPU_QOS_CLASS;
   * qos_weight_pct / qos_yield are the monitor's graded feedback; the
   * wait/cost counters and the log2 wait histogram are written by the
   * rate limiter on every gated dispatch. */
  int32_t qos_class;      /* VGPU_QOS_OFF | BEST_EFFORT | LATENCY_CRITICAL */
  int32_t qos_weight_pct; /* duty re-weight, percent of sm_limit; 100 = neutral */
  int32_t qos_yield;      /* 1: best-effort must not borrow idle duty */
  int32_t qos_pad_;
  uint64_t qos_wait_count;    /* dispatches that passed the QoS gate */
  uint64_t qos_wait_us_total; /* total us spent blocked at the gate */
  uint64_t qos_cost_us_total; /* total device-us charged through the gate */
  uint64_t qos_wait_hist[VGPU_QOS_WAIT_BUCKETS];
} vgpu_region_t;

#ifdef __cplusplus
} /* extern "C" */

/* The layout the node monitor reads (x86-64 Linux, glibc's 40-byte
 * pthread_mutex_t), the same numbers as the TPU library's region. */
static_assert(sizeof(pthread_mutex_t) == 40, "pthread_mutex_t size");
static_assert(sizeof(vgpu_proc_slot_t) == 272, "proc slot size");
static_assert(offsetof(vgpu_proc_slot_t, used) == 16, "slot.used");
static_assert(offsetof(vgpu_proc_slot_t, monitor_used) == 144,
              "slot.monitor_used");
static_assert(sizeof(vgpu_region_t) == 280104, "region size");
static_assert(offsetof(vgpu_region_t, generation) == 24, "generation");
static_assert(offsetof(vgpu_region_t, lock) == 32, "lock");
static_assert(offsetof(vgpu_region_t, uuids) == 72, "uuids");
static_assert(offsetof(vgpu_region_t, limit) == 1096, "limit");
static_assert(offsetof(vgpu_region_t, sm_limit) == 1224, "sm_limit");
static_assert(offsetof(vgpu_region_t, utilization_switch) == 1352,
              "utilization_switch");
static_assert(offsetof(vgpu_region_t, priority) == 1360, "priority");
static_assert(offsetof(vgpu_region_t, oversubscribe) == 1364,
              "oversubscribe");
static_assert(offsetof(vgpu_region_t, proc_num) == 1368, "proc_num");
static_assert(offsetof(vgpu_region_t, procs) == 1376, "procs");
static_assert(offsetof(vgpu_region_t, qos_class) == 279904, "qos_class");
static_assert(offsetof(vgpu_region_t, qos_wait_count) == 279920,
              "qos_wait_count");
static_assert(offsetof(vgpu_region_t, qos_wait_hist) == 279944,
              "qos_wait_hist");
#endif

#endif /* VGPU_SHARED_REGION_H_ */
