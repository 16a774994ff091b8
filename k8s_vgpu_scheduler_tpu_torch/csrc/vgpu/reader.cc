// External-reader API: the node monitor attaches to every container's region
// file from the host side (reference cmd/vGPUmonitor mmaps each
// /tmp/vgpu/containers/<uid_ctr>/*.cache, cudevshr.go:134-148) and drives the
// priority feedback plane.  Opaque-handle accessors keep the struct layout
// private to this library, so Python never mirrors the ABI.

#include <errno.h>
#include <fcntl.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include "shared_region.h"
#include "vgpu.h"

extern "C" {

vgpu_region_t* vgpu_open_region(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(vgpu_region_t)) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, sizeof(vgpu_region_t), PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  vgpu_region_t* r = (vgpu_region_t*)mem;
  if (r->magic != VGPU_MAGIC ||
      !__atomic_load_n(&r->initialized, __ATOMIC_ACQUIRE)) {
    munmap(mem, sizeof(vgpu_region_t));
    return nullptr;
  }
  return r;
}

void vgpu_close_region(vgpu_region_t* r) {
  if (r) munmap(r, sizeof(vgpu_region_t));
}

int vgpu_r_num_devices(vgpu_region_t* r) { return r ? r->num_devices : 0; }

const char* vgpu_r_uuid(vgpu_region_t* r, int dev) {
  if (!r || dev < 0 || dev >= VGPU_MAX_DEVICES) return "";
  return r->uuids[dev];
}

uint64_t vgpu_r_limit(vgpu_region_t* r, int dev) {
  if (!r || dev < 0 || dev >= VGPU_MAX_DEVICES) return 0;
  return r->limit[dev];
}

uint64_t vgpu_r_sm_limit(vgpu_region_t* r, int dev) {
  if (!r || dev < 0 || dev >= VGPU_MAX_DEVICES) return 0;
  return r->sm_limit[dev];
}

uint64_t vgpu_r_used(vgpu_region_t* r, int dev) {
  if (!r || dev < 0 || dev >= VGPU_MAX_DEVICES) return 0;
  uint64_t total = 0;
  for (int i = 0; i < r->proc_num && i < VGPU_MAX_PROCS; i++) {
    if (r->procs[i].pid != 0) total += r->procs[i].used[dev];
  }
  return total;
}

int vgpu_r_priority(vgpu_region_t* r) { return r ? r->priority : 0; }

int vgpu_r_oversubscribe(vgpu_region_t* r) { return r ? r->oversubscribe : 0; }

int vgpu_r_recent_kernel(vgpu_region_t* r) { return r ? r->recent_kernel : 0; }

/* Age the activity counter toward zero; returns the value BEFORE aging
 * (reference Observe decrements recentKernel each tick, feedback.go:178). */
int vgpu_r_age_kernel(vgpu_region_t* r) {
  if (!r) return 0;
  int v = __atomic_load_n(&r->recent_kernel, __ATOMIC_RELAXED);
  if (v > 0) __atomic_store_n(&r->recent_kernel, v - 1, __ATOMIC_RELAXED);
  return v;
}

int vgpu_r_get_switch(vgpu_region_t* r) { return r ? r->utilization_switch : 0; }

void vgpu_r_set_switch(vgpu_region_t* r, int on) {
  if (r) __atomic_store_n(&r->utilization_switch, on ? 1 : 0, __ATOMIC_RELAXED);
}

int vgpu_r_proc_pids(vgpu_region_t* r, int32_t* out, int max) {
  if (!r || !out) return 0;
  int n = 0;
  for (int i = 0; i < r->proc_num && i < VGPU_MAX_PROCS && n < max; i++) {
    if (r->procs[i].pid != 0) out[n++] = r->procs[i].pid;
  }
  return n;
}

void vgpu_r_set_hostpid(vgpu_region_t* r, int32_t pid, int32_t hostpid) {
  if (!r) return;
  for (int i = 0; i < r->proc_num && i < VGPU_MAX_PROCS; i++) {
    if (r->procs[i].pid == pid) {
      r->procs[i].hostpid = hostpid;
      return;
    }
  }
}

void vgpu_r_set_monitor_used(vgpu_region_t* r, int32_t pid, int dev,
                             uint64_t bytes) {
  if (!r || dev < 0 || dev >= VGPU_MAX_DEVICES) return;
  for (int i = 0; i < r->proc_num && i < VGPU_MAX_PROCS; i++) {
    if (r->procs[i].pid == pid) {
      r->procs[i].monitor_used[dev] = bytes;
      return;
    }
  }
}

/* Clear slots whose in-container pid no longer exists in `live_pids`
 * (monitor GC of crashed processes; the reference recovers these via
 * fix_lock_shrreg + status flags).  Returns slots cleared. */
int vgpu_r_gc(vgpu_region_t* r, const int32_t* live_pids, int n_live) {
  if (!r) return 0;
  int cleared = 0;
  for (int i = 0; i < r->proc_num && i < VGPU_MAX_PROCS; i++) {
    int32_t pid = r->procs[i].pid;
    if (pid == 0) continue;
    bool alive = false;
    for (int j = 0; j < n_live; j++) {
      if (live_pids[j] == pid) {
        alive = true;
        break;
      }
    }
    if (!alive) {
      memset(&r->procs[i], 0, sizeof(vgpu_proc_slot_t));
      cleared++;
    }
  }
  if (cleared) r->generation++;
  return cleared;
}

uint64_t vgpu_r_generation(vgpu_region_t* r) { return r ? r->generation : 0; }

/* -- QoS plane ------------------------------------------------------------- */

int vgpu_r_qos_class(vgpu_region_t* r) {
  return r ? __atomic_load_n(&r->qos_class, __ATOMIC_RELAXED) : VGPU_QOS_OFF;
}

int vgpu_r_qos_weight(vgpu_region_t* r) {
  if (!r) return 100;
  int w = __atomic_load_n(&r->qos_weight_pct, __ATOMIC_RELAXED);
  return w > 0 ? w : 100;
}

void vgpu_r_set_qos_weight(vgpu_region_t* r, int pct) {
  if (r && pct > 0)
    __atomic_store_n(&r->qos_weight_pct, pct, __ATOMIC_RELAXED);
}

int vgpu_r_qos_yield(vgpu_region_t* r) {
  return r ? __atomic_load_n(&r->qos_yield, __ATOMIC_RELAXED) : 0;
}

void vgpu_r_set_qos_yield(vgpu_region_t* r, int on) {
  if (r) __atomic_store_n(&r->qos_yield, on ? 1 : 0, __ATOMIC_RELAXED);
}

uint64_t vgpu_r_qos_wait_count(vgpu_region_t* r) {
  return r ? __atomic_load_n(&r->qos_wait_count, __ATOMIC_RELAXED) : 0;
}

uint64_t vgpu_r_qos_wait_us_total(vgpu_region_t* r) {
  return r ? __atomic_load_n(&r->qos_wait_us_total, __ATOMIC_RELAXED) : 0;
}

uint64_t vgpu_r_qos_cost_us_total(vgpu_region_t* r) {
  return r ? __atomic_load_n(&r->qos_cost_us_total, __ATOMIC_RELAXED) : 0;
}

int vgpu_r_qos_wait_hist(vgpu_region_t* r, uint64_t* out, int max) {
  if (!r || !out || max <= 0) return 0;
  int n = max < VGPU_QOS_WAIT_BUCKETS ? max : VGPU_QOS_WAIT_BUCKETS;
  for (int i = 0; i < n; i++)
    out[i] = __atomic_load_n(&r->qos_wait_hist[i], __ATOMIC_RELAXED);
  return n;
}

}  // extern "C"
