/* libvgpu_torch public C API — consumed by the port's Python shim (ctypes)
 * and by any reader of the shared region.
 *
 * The CUDA port's counterpart of the TPU library's API, function for
 * function with a `vgpu_` prefix.  It reads the reference's GPU env names
 * (CUDA_DEVICE_MEMORY_LIMIT_<i>, CUDA_DEVICE_SM_LIMIT,
 * NVIDIA_VISIBLE_DEVICES, CUDA_TASK_PRIORITY, CUDA_OVERSUBSCRIBE,
 * CUDA_DEVICE_MEMORY_SHARED_CACHE).  The compute path calls into it at
 * dispatch and allocation boundaries.
 */
#ifndef VGPU_VGPU_H_
#define VGPU_VGPU_H_

#include <stdint.h>

#include "shared_region.h"

#ifdef __cplusplus
extern "C" {
#endif

/* -- lifecycle ------------------------------------------------------------ */
/* Attach to (creating if needed) the shared region at `path`, or at
 * $CUDA_DEVICE_MEMORY_SHARED_CACHE / /tmp/cudevshr.cache when NULL.
 * Registers the calling process in a proc slot.  Returns 0 or -errno. */
int vgpu_init_path(const char* path);
int vgpu_init(void);
void vgpu_shutdown(void);
int vgpu_initialized(void);

/* -- device-memory accounting --------------------------------------------- */
uint64_t vgpu_get_limit(int dev);
uint64_t vgpu_get_sm_limit(int dev);
uint64_t vgpu_get_used(int dev);
int vgpu_try_alloc(int dev, uint64_t bytes); /* 0 | -ENOMEM | -EINVAL */
void vgpu_charge(int dev, uint64_t bytes);   /* unconditional add (post-hoc) */
void vgpu_set_used(int dev, uint64_t bytes); /* absolute self-report */
void vgpu_free(int dev, uint64_t bytes);
void vgpu_memory_info(int dev, uint64_t* total, uint64_t* used);
/* Reap charges of same-pid-namespace slot owners that died without
 * vgpu_shutdown.  Runs automatically at attach and before any -ENOMEM
 * refusal.  Returns slots reaped. */
int vgpu_gc_dead(void);
int vgpu_proc_count(void);
const char* vgpu_region_path(void);
vgpu_region_t* vgpu_region(void);

/* -- dispatch rate limiter ------------------------------------------------ */
/* Gate one dispatch on device `dev`: sleep until the duty-cycle budget
 * implied by sm_limit[dev] admits it.  `cost_us` is the caller's estimate
 * of the dispatch's device-busy time (0 = the last feedback, or a
 * default).  Never blocks when sm_limit is 0/100, or when the process is
 * high priority and no higher-priority sharer is active, unless
 * GPU_CORE_UTILIZATION_POLICY=force. */
void vgpu_rate_acquire(int dev, uint64_t cost_us);
/* How long the last dispatch kept the device busy. */
void vgpu_rate_feedback(int dev, uint64_t busy_us);

/* Deterministic test clock: when on, the limiter reads a manual clock and
 * its wait loop advances it instead of sleeping.  Enabling resets all
 * buckets. */
void vgpu_rate_test_mode(int on);
void vgpu_rate_test_advance(uint64_t ns);
uint64_t vgpu_rate_test_now(void);

/* -- external reader API (node monitor, or a process on its own region) --- */
vgpu_region_t* vgpu_open_region(const char* path);
void vgpu_close_region(vgpu_region_t* r);
int vgpu_r_num_devices(vgpu_region_t* r);
const char* vgpu_r_uuid(vgpu_region_t* r, int dev);
uint64_t vgpu_r_limit(vgpu_region_t* r, int dev);
uint64_t vgpu_r_sm_limit(vgpu_region_t* r, int dev);
uint64_t vgpu_r_used(vgpu_region_t* r, int dev);
int vgpu_r_priority(vgpu_region_t* r);
int vgpu_r_oversubscribe(vgpu_region_t* r);
int vgpu_r_recent_kernel(vgpu_region_t* r);
int vgpu_r_age_kernel(vgpu_region_t* r);
int vgpu_r_get_switch(vgpu_region_t* r);
void vgpu_r_set_switch(vgpu_region_t* r, int on);
int vgpu_r_proc_pids(vgpu_region_t* r, int32_t* out, int max);
void vgpu_r_set_hostpid(vgpu_region_t* r, int32_t pid, int32_t hostpid);
void vgpu_r_set_monitor_used(vgpu_region_t* r, int32_t pid, int dev,
                             uint64_t bytes);
int vgpu_r_gc(vgpu_region_t* r, const int32_t* live_pids, int n_live);
uint64_t vgpu_r_generation(vgpu_region_t* r);

/* -- QoS plane ------------------------------------------------------------- */
int vgpu_r_qos_class(vgpu_region_t* r);
int vgpu_r_qos_weight(vgpu_region_t* r);
void vgpu_r_set_qos_weight(vgpu_region_t* r, int pct);
int vgpu_r_qos_yield(vgpu_region_t* r);
void vgpu_r_set_qos_yield(vgpu_region_t* r, int on);
uint64_t vgpu_r_qos_wait_count(vgpu_region_t* r);
uint64_t vgpu_r_qos_wait_us_total(vgpu_region_t* r);
uint64_t vgpu_r_qos_cost_us_total(vgpu_region_t* r);
int vgpu_r_qos_wait_hist(vgpu_region_t* r, uint64_t* out, int max);

#ifdef __cplusplus
}
#endif

#endif /* VGPU_VGPU_H_ */
