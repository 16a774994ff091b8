// Shared-region lifecycle + device-memory accounting, for the CUDA port.
//
// The port's copy of the TPU library's region.cc: a rebuild of the
// reference intercept library's region management (binary-only libvgpu.so
// symbols: try_create_shrreg / lock_shrreg / fix_lock_shrreg / oom_check /
// add_gpu_device_memory_usage — see SURVEY.md N1) as portable C++17 with a
// pthread robust mutex doing the dead-owner recovery.  It reads the
// reference's GPU env names (SURVEY.md §3.4) where the TPU copy reads
// TPU_* ones; the region it writes is byte-compatible with the TPU one.

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>

#include "shared_region.h"
#include "vgpu.h"

namespace {

vgpu_region_t* g_region = nullptr;
int g_slot = -1;
char g_path[4096] = {0};

uint64_t env_mib(const char* name) {
  const char* v = getenv(name);
  if (!v || !*v) return 0;
  char* end = nullptr;
  double x = strtod(v, &end);
  if (end == v || x < 0) return 0;
  // Values may carry an 'm'/'M' suffix like the reference ("3000m"); the
  // unit is MiB either way.
  return (uint64_t)(x * 1024.0 * 1024.0);
}

long env_long(const char* name, long fallback) {
  const char* v = getenv(name);
  if (!v || !*v) return fallback;
  char* end = nullptr;
  long x = strtol(v, &end, 10);
  return end == v ? fallback : x;
}

void region_lock(vgpu_region_t* r) {
  int rc = pthread_mutex_lock(&r->lock);
  if (rc == EOWNERDEAD) {
    // Previous holder died mid-critical-section: the accounting may be
    // slightly stale (their proc slot is GC'd by the monitor), but the
    // mutex itself is recoverable.
    pthread_mutex_consistent(&r->lock);
  }
}

void region_unlock(vgpu_region_t* r) { pthread_mutex_unlock(&r->lock); }

/* Truncated nsfs inode of this process's pid namespace (0 = unknown). */
uint32_t self_pidns(void) {
  struct stat st;
  if (stat("/proc/self/ns/pid", &st) != 0) return 0;
  return (uint32_t)st.st_ino;
}

/* Clear slots whose owner died without vgpu_shutdown (SIGKILLed worker,
 * aborted runtime).  Probe only slots written from OUR pid namespace —
 * kill(pid, 0) against a foreign namespace's pid numbers would report
 * ESRCH (or hit an unrelated process) for a perfectly alive sharer in
 * another container; those slots belong to the host monitor's NSpid GC.
 * Caller holds the region lock.  Returns slots reaped. */
int reap_dead_locked(vgpu_region_t* r) {
  uint32_t ns = self_pidns();
  if (ns == 0) return 0;
  int me = (int)getpid();
  int reaped = 0;
  for (int i = 0; i < r->proc_num; i++) {
    vgpu_proc_slot_t* s = &r->procs[i];
    if (s->pid == 0 || s->pid == me) continue;
    if ((uint32_t)s->pidns != ns) continue;
    if (kill(s->pid, 0) != 0 && errno == ESRCH) {
      memset(s, 0, sizeof(*s));
      reaped++;
    }
  }
  if (reaped) r->generation++;
  return reaped;
}

void init_mutex(vgpu_region_t* r) {
  pthread_mutexattr_t a;
  pthread_mutexattr_init(&a);
  pthread_mutexattr_setpshared(&a, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&a, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&r->lock, &a);
  pthread_mutexattr_destroy(&a);
}

void apply_env_limits(vgpu_region_t* r) {
  char name[64];
  int n = 0;
  for (int i = 0; i < VGPU_MAX_DEVICES; i++) {
    snprintf(name, sizeof(name), "CUDA_DEVICE_MEMORY_LIMIT_%d", i);
    uint64_t lim = env_mib(name);
    if (lim == 0 && i == 0) lim = env_mib("CUDA_DEVICE_MEMORY_LIMIT");
    if (lim > 0) {
      r->limit[i] = lim;
      n = i + 1;
    }
  }
  long sms = env_long("CUDA_DEVICE_SM_LIMIT", 0);
  for (int i = 0; i < VGPU_MAX_DEVICES; i++) {
    r->sm_limit[i] = (sms > 0 && sms < 100) ? (uint64_t)sms : 0;
  }
  // GPU UUIDs in device order.  The container runtime's keywords ("all",
  // "none", "void") name no device.
  const char* gpus = getenv("NVIDIA_VISIBLE_DEVICES");
  if (gpus && *gpus && strcmp(gpus, "all") && strcmp(gpus, "none") &&
      strcmp(gpus, "void")) {
    int idx = 0;
    const char* p = gpus;
    while (*p && idx < VGPU_MAX_DEVICES) {
      const char* comma = strchr(p, ',');
      size_t len = comma ? (size_t)(comma - p) : strlen(p);
      if (len >= VGPU_UUID_LEN) len = VGPU_UUID_LEN - 1;
      memcpy(r->uuids[idx], p, len);
      r->uuids[idx][len] = 0;
      idx++;
      if (!comma) break;
      p = comma + 1;
    }
    if (idx > n) n = idx;
  }
  if (n == 0) n = 1;
  r->num_devices = n;
  r->priority = (int32_t)env_long("CUDA_TASK_PRIORITY", 0);
  const char* ov = getenv("CUDA_OVERSUBSCRIBE");
  r->oversubscribe = (ov && (!strcmp(ov, "true") || !strcmp(ov, "1"))) ? 1 : 0;
  /* QoS class (vtpu.dev/qos -> device plugin VTPU_QOS_CLASS; the reference
   * has no counterpart, so the name is the project's own).  Absent or
   * unrecognized -> VGPU_QOS_OFF: the limiter takes the flat path bit for
   * bit. */
  r->qos_class = VGPU_QOS_OFF;
  const char* qos = getenv("VTPU_QOS_CLASS");
  if (qos && *qos) {
    if (!strcmp(qos, "latency-critical"))
      r->qos_class = VGPU_QOS_LATENCY_CRITICAL;
    else if (!strcmp(qos, "best-effort"))
      r->qos_class = VGPU_QOS_BEST_EFFORT;
  }
  r->qos_weight_pct = 100;
}

}  // namespace

extern "C" {

int vgpu_init_path(const char* path) {
  if (g_region) return 0;
  if (!path || !*path) {
    path = getenv("CUDA_DEVICE_MEMORY_SHARED_CACHE");
    if (!path || !*path) path = "/tmp/cudevshr.cache";
  }
  snprintf(g_path, sizeof(g_path), "%s", path);

  // Ensure parent dir exists (container path is a fresh mount).
  char dir[4096];
  snprintf(dir, sizeof(dir), "%s", path);
  char* slash = strrchr(dir, '/');
  if (slash && slash != dir) {
    *slash = 0;
    mkdir(dir, 0777);
  }

  int fd = open(path, O_RDWR | O_CREAT, 0666);
  if (fd < 0) return -errno;

  // Creation race: first process to win the flock initializes.
  if (flock(fd, LOCK_EX) != 0) {
    close(fd);
    return -errno;
  }
  struct stat st;
  if (fstat(fd, &st) != 0) {
    flock(fd, LOCK_UN);
    close(fd);
    return -errno;
  }
  bool fresh = (size_t)st.st_size < sizeof(vgpu_region_t);
  if (fresh && ftruncate(fd, sizeof(vgpu_region_t)) != 0) {
    flock(fd, LOCK_UN);
    close(fd);
    return -errno;
  }
  void* mem = mmap(nullptr, sizeof(vgpu_region_t), PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    flock(fd, LOCK_UN);
    close(fd);
    return -errno;
  }
  vgpu_region_t* r = (vgpu_region_t*)mem;
  if (fresh || r->magic != VGPU_MAGIC) {
    memset(r, 0, sizeof(*r));
    init_mutex(r);
    r->magic = VGPU_MAGIC;
    r->abi_version = VGPU_ABI_VERSION;
    r->owner_pid = getpid();
    apply_env_limits(r);
    __atomic_store_n(&r->initialized, 1, __ATOMIC_RELEASE);
  }
  flock(fd, LOCK_UN);
  close(fd);

  // Register this process in a free slot.  Reap same-namespace dead
  // owners first: a sharer that crashed mid-allocation must not pin its
  // charges against the cap forever (nor exhaust the slot table).
  region_lock(r);
  reap_dead_locked(r);
  int slot = -1;
  for (int i = 0; i < VGPU_MAX_PROCS; i++) {
    if (r->procs[i].pid == 0) {
      slot = i;
      break;
    }
  }
  if (slot >= 0) {
    memset(&r->procs[slot], 0, sizeof(vgpu_proc_slot_t));
    r->procs[slot].pid = getpid();
    r->procs[slot].status = 1;
    r->procs[slot].pidns = (int32_t)self_pidns();
    if (slot + 1 > r->proc_num) r->proc_num = slot + 1;
  }
  r->generation++;
  region_unlock(r);
  if (slot < 0) {
    munmap(mem, sizeof(vgpu_region_t));
    return -EAGAIN;
  }
  g_region = r;
  g_slot = slot;
  return 0;
}

int vgpu_init(void) { return vgpu_init_path(nullptr); }

void vgpu_shutdown(void) {
  if (!g_region) return;
  region_lock(g_region);
  if (g_slot >= 0) memset(&g_region->procs[g_slot], 0, sizeof(vgpu_proc_slot_t));
  g_region->generation++;
  region_unlock(g_region);
  munmap(g_region, sizeof(vgpu_region_t));
  g_region = nullptr;
  g_slot = -1;
}

int vgpu_initialized(void) { return g_region != nullptr; }

uint64_t vgpu_get_limit(int dev) {
  if (!g_region || dev < 0 || dev >= VGPU_MAX_DEVICES) return 0;
  return g_region->limit[dev];
}

uint64_t vgpu_get_sm_limit(int dev) {
  if (!g_region || dev < 0 || dev >= VGPU_MAX_DEVICES) return 0;
  return g_region->sm_limit[dev];
}

uint64_t vgpu_get_used(int dev) {
  if (!g_region || dev < 0 || dev >= VGPU_MAX_DEVICES) return 0;
  uint64_t total = 0;
  region_lock(g_region);
  for (int i = 0; i < g_region->proc_num; i++) {
    if (g_region->procs[i].pid != 0) total += g_region->procs[i].used[dev];
  }
  region_unlock(g_region);
  return total;
}

/* oom_check + add in one atomic step (the reference does oom_check then
 * add_gpu_device_memory_usage separately; that is a TOCTOU between sharers).
 * Returns 0 on success, -ENOMEM when the cap would be exceeded. */
int vgpu_try_alloc(int dev, uint64_t bytes) {
  if (!g_region || g_slot < 0) return -EINVAL;
  if (dev < 0 || dev >= VGPU_MAX_DEVICES) return -EINVAL;
  vgpu_region_t* r = g_region;
  int rc = 0;
  region_lock(r);
  uint64_t lim = r->limit[dev];
  if (lim > 0) {
    uint64_t total = 0;
    for (int i = 0; i < r->proc_num; i++) {
      if (r->procs[i].pid != 0) total += r->procs[i].used[dev];
    }
    if (total + bytes > lim && reap_dead_locked(r) > 0) {
      // About to refuse: make sure the refusal isn't caused by a crashed
      // sharer's stale charges (cold path, so the pid probes are cheap).
      total = 0;
      for (int i = 0; i < r->proc_num; i++) {
        if (r->procs[i].pid != 0) total += r->procs[i].used[dev];
      }
    }
    if (total + bytes > lim) rc = -ENOMEM;
  }
  if (rc == 0) {
    r->procs[g_slot].used[dev] += bytes;
    r->generation++;
  }
  region_unlock(r);
  return rc;
}

/* Unconditional add — for charging allocations that already exist (e.g.
 * buffers an allocation interposer observes after the fact).  Refusal is not possible for them; the OOM watchdog acts on
 * the resulting over-limit state instead. */
void vgpu_charge(int dev, uint64_t bytes) {
  if (!g_region || g_slot < 0) return;
  if (dev < 0 || dev >= VGPU_MAX_DEVICES) return;
  region_lock(g_region);
  g_region->procs[g_slot].used[dev] += bytes;
  g_region->generation++;
  region_unlock(g_region);
}

/* Absolute self-report for poll-based accounting (the Python shim samples
 * the caching allocator's reserved bytes and publishes them; delta tracking
 * via try_alloc/free is for allocation-site interposers). */
void vgpu_set_used(int dev, uint64_t bytes) {
  if (!g_region || g_slot < 0) return;
  if (dev < 0 || dev >= VGPU_MAX_DEVICES) return;
  region_lock(g_region);
  g_region->procs[g_slot].used[dev] = bytes;
  g_region->generation++;
  region_unlock(g_region);
}

void vgpu_free(int dev, uint64_t bytes) {
  if (!g_region || g_slot < 0) return;
  if (dev < 0 || dev >= VGPU_MAX_DEVICES) return;
  region_lock(g_region);
  uint64_t* u = &g_region->procs[g_slot].used[dev];
  *u = (*u >= bytes) ? (*u - bytes) : 0;
  g_region->generation++;
  region_unlock(g_region);
}

/* Virtualized introspection: what "memory info" should report inside the
 * container (reference virtualizes nvmlDeviceGetMemoryInfo so nvidia-smi
 * shows the vGPU limit, README.md:133). */
void vgpu_memory_info(int dev, uint64_t* total, uint64_t* used) {
  uint64_t lim = vgpu_get_limit(dev);
  uint64_t u = vgpu_get_used(dev);
  if (total) *total = lim;
  if (used) *used = u;
}

/* Explicit same-namespace dead-slot sweep; returns slots reaped. */
int vgpu_gc_dead(void) {
  if (!g_region) return 0;
  region_lock(g_region);
  int n = reap_dead_locked(g_region);
  region_unlock(g_region);
  return n;
}

int vgpu_proc_count(void) {
  if (!g_region) return 0;
  int n = 0;
  region_lock(g_region);
  for (int i = 0; i < g_region->proc_num; i++) {
    if (g_region->procs[i].pid != 0) n++;
  }
  region_unlock(g_region);
  return n;
}

const char* vgpu_region_path(void) { return g_path; }

vgpu_region_t* vgpu_region(void) { return g_region; }

}  // extern "C"
