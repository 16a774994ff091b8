// CUDA driver-API interposer: in-container enforcement for every CUDA
// process of a pod, loaded with LD_PRELOAD.  The port's counterpart of the
// TPU library's PJRT interposer and preload constructor
// (pjrt_interposer.cc, preload.cc), built on the same region and limiter
// code as libvgpu_torch (one .so carries both).
//
// The reference's libvgpu.so hooks the CUDA driver API and NVML through
// dlsym interposition and is preloaded into every process (SURVEY.md
// §2.2 N1), so a process is capped and throttled whether or not it
// imports a cooperating library.  This library does the same:
//
// Symbol lookup.  It exports a `dlsym` that hands out its own hook for
// every hooked name, and hooks cuGetProcAddress/cuGetProcAddress_v2.  The
// CUDA 12 runtime under torch opens libcuda.so.1 itself, fetches
// cuGetProcAddress_v2 with dlsym and every other entry point through it
// (torch's c10::cuda::DriverAPI does the same through
// cudaGetDriverEntryPoint), so exporting cuMemAlloc_v2 alone would
// intercept nothing.  A pointer a lookup hands out is matched to its hook
// by the name, CUDA version and stream flag asked for, as the driver maps
// them (cuMemAlloc at 3020 or later -> cuMemAlloc_v2, cuLaunchKernel with
// the per-thread flag -> cuLaunchKernel_ptsz), so an internal entry point
// the driver may hand out in place of its exported symbol is caught too.
// The real dlsym is fetched with dlvsym (GLIBC_2.34, then GLIBC_2.2.5),
// never through the hooked name.  Programs linked against libcuda
// directly bind to the exported hooks.
//
// Memory.  cuMemAlloc_v2, cuMemAllocPitch_v2, cuMemAllocManaged,
// cuMemAllocAsync, cuMemAllocFromPoolAsync (and their _ptsz forms) and the
// VMM cuMemCreate (torch's expandable_segments) charge the current device
// (cuMemCreate: its location) through vgpu_try_alloc, atomically against
// the pod's grant, and return CUDA_ERROR_OUT_OF_MEMORY past it, leaving
// the driver untouched (torch's caching allocator empties its cache and
// retries once, then raises torch.OutOfMemoryError).  cuMemFree_v2,
// cuMemFreeAsync and cuMemRelease release what was charged, from a
// pointer or handle -> (bytes, device) map.
//
// The context.  Every context the process makes (the first
// cuDevicePrimaryCtxRetain of a device, each cuCtxCreate_v2/_v3/_v4) is
// charged a fixed footprint before the driver is called, and refused with
// CUDA_ERROR_OUT_OF_MEMORY where the grant cannot hold it: VTPU_CONTEXT_MIB
// (MiB, default 640), the context and the code its process loads outside
// any allocation.  The default covers what chip_smoke.py reads for a torch
// process that ran the 32-layer forward on an H100 80GB HBM3 at 700 W:
// 621.9 MiB on the card outside its allocations (its `footprint_bytes`);
// a node with another card or driver sets its own from that reading.
// Nothing is measured at run time: the card is shared, and the fall of its
// free memory around a call counts what other processes allocate or free
// in that window too.  So the charge needs no NVML, and no other process
// moves it.
//
// Memory info.  cuMemGetInfo_v2, cuDeviceTotalMem_v2,
// nvmlDeviceGetMemoryInfo and nvmlDeviceGetMemoryInfo_v2 report the grant
// as the total and the region's `used` (all of the pod's processes) as
// used, as Device_MemoryStats does in the PJRT interposer.  NVML devices
// map to region slots by UUID (NVIDIA_VISIBLE_DEVICES), else by index.
//
// Launches.  cuLaunchKernel, cuLaunchKernelEx, cuLaunchCooperativeKernel,
// cuGraphLaunch and their _ptsz forms go through vgpu_rate_acquire with
// the launch's device time as its cost.  Device time comes from the
// driver's events, never the host's enqueue time: a launch is timed with
// an event pair around it on its own stream, read later without waiting
// (on an idle device less the host's time to submit the launch after the
// start event).  Each (function, grid, block)
// keeps its own estimate: its first two launches are timed, then every
// 64th.  A launch timed while the monitor's switch is on (a higher-priority
// pod is active on the card, whose time is sliced between the two pods'
// contexts) may only lower an estimate that already has one: its pair can
// span the other pod's slices too, which would charge the pod its
// neighbour's time, and the samples that span none pull back what the
// last tick before the switch let in.  Where no device is capped the
// launch only marks activity for the monitor: no lock, no syscall.
// Launches into a stream that is being captured run nothing and are not
// charged; the graph's launch is.
//
// Lifecycle.  The constructor attaches to the region only when
// CUDA_DEVICE_MEMORY_SHARED_CACHE is set and VTPU_DISABLE is not (as
// preload.cc); the destructor calls vgpu_shutdown.  Outside a managed
// container every hook passes through.  Inside one, a failed attach makes
// cuInit fail loudly: the process never runs unenforced.  A hook whose
// real entry point cannot be resolved fails its call.
//
// Known limits (documented, not silent): a process whose code, local
// memory (a kernel's stack past the context's) or module globals outgrow
// the fixed footprint passes its grant by the difference, and one that
// needs less is refused early by it; the 32-bit v1 entry points
// (cuMemAlloc, cuMemFree, cuCtxCreate, ...) are not hooked; stream-ordered
// allocations are charged at the allocation's enqueue and released at the
// free's, so what a memory pool keeps reserved beyond its live allocations
// is not charged; graph memory nodes (cuGraphAddMemAllocNode), arrays
// (cuArrayCreate) and what cuGraphInstantiate loads are not charged; a
// context's charge stays until the process exits; a fork()ed child shares
// its parent's region slot until it execs; dlsym(RTLD_NEXT, ...) made by
// another library resolves relative to this one.

#include <dlfcn.h>
#include <errno.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include <atomic>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include "cuda_types.h"
#include "shared_region.h"
#include "vgpu.h"

// Every hooked name.  The hooks are defined below under these exact names
// and exported, so a program linked against libcuda binds to them too.
#define VGPU_CU_HOOKS(X)                                                    \
  X(cuInit) X(cuGetProcAddress) X(cuGetProcAddress_v2) X(cuMemAlloc_v2)     \
  X(cuMemAllocPitch_v2) X(cuMemAllocManaged) X(cuMemFree_v2)                \
  X(cuMemAllocAsync) X(cuMemAllocAsync_ptsz) X(cuMemAllocFromPoolAsync)     \
  X(cuMemAllocFromPoolAsync_ptsz) X(cuMemFreeAsync) X(cuMemFreeAsync_ptsz)  \
  X(cuMemCreate) X(cuMemRelease) X(cuMemGetInfo_v2) X(cuDeviceTotalMem_v2)  \
  X(cuDevicePrimaryCtxRetain) X(cuCtxCreate_v2) X(cuCtxCreate_v3)           \
  X(cuCtxCreate_v4) X(cuLaunchKernel) X(cuLaunchKernel_ptsz)                \
  X(cuLaunchKernelEx) X(cuLaunchKernelEx_ptsz) X(cuLaunchCooperativeKernel) \
  X(cuLaunchCooperativeKernel_ptsz) X(cuGraphLaunch) X(cuGraphLaunch_ptsz)
#define VGPU_NVML_HOOKS(X) \
  X(nvmlDeviceGetMemoryInfo) X(nvmlDeviceGetMemoryInfo_v2)

#define VGPU_LAUNCH_ARGS                                                   \
  CUfunction f, unsigned int gx, unsigned int gy, unsigned int gz,         \
      unsigned int bx, unsigned int by, unsigned int bz, unsigned int shm, \
      CUstream s, void **params

extern "C" {
CUresult cuInit(unsigned int flags);
CUresult cuGetProcAddress(const char* symbol, void** pfn, int version,
                          cuuint64_t flags);
CUresult cuGetProcAddress_v2(const char* symbol, void** pfn, int version,
                             cuuint64_t flags,
                             CUdriverProcAddressQueryResult* status);
CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t bytes);
CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pitch, size_t width,
                            size_t height, unsigned int elem);
CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t bytes,
                           unsigned int flags);
CUresult cuMemFree_v2(CUdeviceptr dptr);
CUresult cuMemAllocAsync(CUdeviceptr* dptr, size_t bytes, CUstream s);
CUresult cuMemAllocAsync_ptsz(CUdeviceptr* dptr, size_t bytes, CUstream s);
CUresult cuMemAllocFromPoolAsync(CUdeviceptr* dptr, size_t bytes,
                                 CUmemoryPool pool, CUstream s);
CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr* dptr, size_t bytes,
                                      CUmemoryPool pool, CUstream s);
CUresult cuMemFreeAsync(CUdeviceptr dptr, CUstream s);
CUresult cuMemFreeAsync_ptsz(CUdeviceptr dptr, CUstream s);
CUresult cuMemCreate(CUmemGenericAllocationHandle* handle, size_t bytes,
                     const CUmemAllocationProp* prop,
                     unsigned long long flags);
CUresult cuMemRelease(CUmemGenericAllocationHandle handle);
CUresult cuMemGetInfo_v2(size_t* free_bytes, size_t* total);
CUresult cuDeviceTotalMem_v2(size_t* bytes, CUdevice dev);
CUresult cuDevicePrimaryCtxRetain(CUcontext* pctx, CUdevice dev);
CUresult cuCtxCreate_v2(CUcontext* pctx, unsigned int flags, CUdevice dev);
CUresult cuCtxCreate_v3(CUcontext* pctx, void* params, int n,
                        unsigned int flags, CUdevice dev);
CUresult cuCtxCreate_v4(CUcontext* pctx, void* params, unsigned int flags,
                        CUdevice dev);
CUresult cuLaunchKernel(VGPU_LAUNCH_ARGS, void** extra);
CUresult cuLaunchKernel_ptsz(VGPU_LAUNCH_ARGS, void** extra);
CUresult cuLaunchKernelEx(const CUlaunchConfig* cfg, CUfunction f,
                          void** params, void** extra);
CUresult cuLaunchKernelEx_ptsz(const CUlaunchConfig* cfg, CUfunction f,
                               void** params, void** extra);
CUresult cuLaunchCooperativeKernel(VGPU_LAUNCH_ARGS);
CUresult cuLaunchCooperativeKernel_ptsz(VGPU_LAUNCH_ARGS);
CUresult cuGraphLaunch(CUgraphExec g, CUstream s);
CUresult cuGraphLaunch_ptsz(CUgraphExec g, CUstream s);
nvmlReturn_t nvmlDeviceGetMemoryInfo(nvmlDevice_t d, nvmlMemory_t* m);
nvmlReturn_t nvmlDeviceGetMemoryInfo_v2(nvmlDevice_t d, nvmlMemory_v2_t* m);
}

namespace {

enum HookId {
#define X(n) H_##n,
  VGPU_CU_HOOKS(X) VGPU_NVML_HOOKS(X)
#undef X
  H_COUNT
};
constexpr int H_NVML_FIRST_ = H_nvmlDeviceGetMemoryInfo;

struct HookEntry {
  const char* name;
  void* fn;
};

const HookEntry kHooks[H_COUNT] = {
#define X(n) {#n, (void*)&n},
    VGPU_CU_HOOKS(X) VGPU_NVML_HOOKS(X)
#undef X
};

constexpr int kNvmlFunctionNotFound = 13;  // NVML_ERROR_FUNCTION_NOT_FOUND
constexpr int kResample = 64;      // re-time a launch shape every 64th
constexpr int kFirstSamples = 2;   // time the first launches of a shape
constexpr int kPending = 64;       // timed launches in flight per thread
constexpr uint64_t kUnknownCostNs = 20000;  // before any launch is timed
constexpr double kDefaultContextMib = 640;  // see "The context" above

std::atomic<void*> g_real[H_COUNT];
bool g_managed = false;   // the container is marked (env present)
bool g_enforce = false;   // attached to the region
bool g_gated = false;     // some device has a compute grant, or QoS is on

// -- real dlsym, driver and NVML ---------------------------------------------
using dlsym_fn = void* (*)(void*, const char*);

dlsym_fn real_dlsym() {
  static std::atomic<dlsym_fn> fn{nullptr};
  dlsym_fn f = fn.load(std::memory_order_acquire);
  if (!f) {
    f = (dlsym_fn)dlvsym(RTLD_NEXT, "dlsym", "GLIBC_2.34");
    if (!f) f = (dlsym_fn)dlvsym(RTLD_NEXT, "dlsym", "GLIBC_2.2.5");
    fn.store(f, std::memory_order_release);
  }
  return f;
}

// The hook of `name`, or -1.  Cheap for the names every process looks up.
int hook_id(const char* name) {
  if (!name || !((name[0] == 'c' && name[1] == 'u') ||
                 !strncmp(name, "nvmlDeviceGetMemoryInfo", 23)))
    return -1;
  for (int i = 0; i < H_COUNT; ++i)
    if (!strcmp(kHooks[i].name, name)) return i;
  return -1;
}

void set_real(int id, void* p) {
  if (!p || p == kHooks[id].fn) return;
  void* expected = nullptr;
  g_real[id].compare_exchange_strong(expected, p);
}

struct DriverAux {
  CUresult (*cuCtxGetDevice)(CUdevice*);
  CUresult (*cuEventCreate)(CUevent*, unsigned int);
  CUresult (*cuEventRecord)(CUevent, CUstream);
  CUresult (*cuEventQuery)(CUevent);
  CUresult (*cuEventElapsedTime)(float*, CUevent, CUevent);
  CUresult (*cuStreamIsCapturing)(CUstream, int*);
} g_cu;

std::once_flag g_driver_once;

void load_driver() {
  std::call_once(g_driver_once, [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (!h) {
      fprintf(stderr, "vgpu-interposer: dlopen(libcuda.so.1): %s\n",
              dlerror());
      return;
    }
    dlsym_fn sym = real_dlsym();
    for (int i = 0; i < H_NVML_FIRST_; ++i) set_real(i, sym(h, kHooks[i].name));
    g_cu.cuCtxGetDevice = (decltype(g_cu.cuCtxGetDevice))sym(h, "cuCtxGetDevice");
    g_cu.cuEventCreate = (decltype(g_cu.cuEventCreate))sym(h, "cuEventCreate");
    g_cu.cuEventRecord = (decltype(g_cu.cuEventRecord))sym(h, "cuEventRecord");
    g_cu.cuEventQuery = (decltype(g_cu.cuEventQuery))sym(h, "cuEventQuery");
    g_cu.cuEventElapsedTime =
        (decltype(g_cu.cuEventElapsedTime))sym(h, "cuEventElapsedTime");
    g_cu.cuStreamIsCapturing =
        (decltype(g_cu.cuStreamIsCapturing))sym(h, "cuStreamIsCapturing");
  });
}

// NVML serves only its own memory-info hooks, whose caller has loaded and
// initialised it: nothing is charged through it.
struct NvmlAux {
  nvmlReturn_t (*GetUUID)(nvmlDevice_t, char*, unsigned int);
  nvmlReturn_t (*GetIndex)(nvmlDevice_t, unsigned int*);
} g_nvml;
std::once_flag g_nvml_once;

void load_nvml() {
  std::call_once(g_nvml_once, [] {
    void* h = dlopen("libnvidia-ml.so.1", RTLD_NOW | RTLD_LOCAL);
    if (!h) return;  // then no process here can call the hooks either
    dlsym_fn sym = real_dlsym();
    for (int i = H_NVML_FIRST_; i < H_COUNT; ++i)
      set_real(i, sym(h, kHooks[i].name));
    g_nvml.GetUUID = (decltype(g_nvml.GetUUID))sym(h, "nvmlDeviceGetUUID");
    g_nvml.GetIndex = (decltype(g_nvml.GetIndex))sym(h, "nvmlDeviceGetIndex");
  });
}

void* real_fn(int id) {
  void* p = g_real[id].load(std::memory_order_acquire);
  if (p) return p;
  if (id < H_NVML_FIRST_)
    load_driver();
  else
    load_nvml();
  return g_real[id].load(std::memory_order_acquire);
}

#define REAL(name) ((decltype(&name))real_fn(H_##name))

// -- per-device bookkeeping ----------------------------------------------------
struct DevStats {
  std::atomic<uint64_t> gated{0}, charged_us{0}, samples{0}, sampled_us{0},
      context_bytes{0}, alloc_bytes{0}, refusals{0}, capture_skips{0};
};
DevStats g_stats[VGPU_MAX_DEVICES];
std::atomic<uint64_t> g_launches{0};

int slot_of(int dev) {
  if (dev < 0) return -1;
  return dev < VGPU_MAX_DEVICES ? dev : VGPU_MAX_DEVICES - 1;
}

int current_slot() {
  load_driver();
  CUdevice d = -1;
  if (!g_cu.cuCtxGetDevice || g_cu.cuCtxGetDevice(&d) != CUDA_SUCCESS)
    return -1;
  return slot_of(d);
}

CUresult unattached(const char* what) {
  static std::atomic<bool> said{false};
  if (!said.exchange(true))
    fprintf(stderr,
            "vgpu-interposer: this container is managed "
            "(CUDA_DEVICE_MEMORY_SHARED_CACHE=%s) but its shared region "
            "could not be attached; %s refused: CUDA does not run "
            "unenforced here\n",
            getenv("CUDA_DEVICE_MEMORY_SHARED_CACHE"), what);
  return CUDA_ERROR_NOT_INITIALIZED;
}

// -- memory ---------------------------------------------------------------------
struct Charge {
  uint64_t bytes;
  int slot;
};
std::mutex g_mem_mu;
std::unordered_map<CUdeviceptr, Charge> g_ptrs;
std::unordered_map<CUmemGenericAllocationHandle, Charge> g_handles;

// 1: charged; 0: refused (past the grant); -1: nothing charged.
int admit(int slot, uint64_t bytes) {
  if (slot < 0) return -1;
  int rc = vgpu_try_alloc(slot, bytes);
  if (rc == 0) return 1;
  if (rc == -ENOMEM) {
    g_stats[slot].refusals.fetch_add(1, std::memory_order_relaxed);
    return 0;
  }
  return -1;
}

template <class Map, class Key>
void remember(Map& map, Key key, uint64_t bytes, int slot) {
  std::lock_guard<std::mutex> g(g_mem_mu);
  map[key] = Charge{bytes, slot};
  g_stats[slot].alloc_bytes.fetch_add(bytes, std::memory_order_relaxed);
}

template <class Map, class Key>
void forget(Map& map, Key key) {
  Charge c{0, -1};
  {
    std::lock_guard<std::mutex> g(g_mem_mu);
    auto it = map.find(key);
    if (it == map.end()) return;
    c = it->second;
    map.erase(it);
  }
  g_stats[c.slot].alloc_bytes.fetch_sub(c.bytes, std::memory_order_relaxed);
  vgpu_free(c.slot, c.bytes);
}

// Charge `bytes` on the current device, make the allocation with `call`,
// remember it by pointer.  Refuses past the grant without calling the
// driver.
template <class F>
CUresult charged_alloc(const char* what, CUdeviceptr* dptr, uint64_t bytes,
                       F&& call) {
  if (!g_enforce) return g_managed ? unattached(what) : call();
  int slot = current_slot();
  int ok = admit(slot, bytes);
  if (ok == 0) return CUDA_ERROR_OUT_OF_MEMORY;
  CUresult rc = call();
  if (ok == 1) {
    if (rc == CUDA_SUCCESS && dptr)
      remember(g_ptrs, *dptr, bytes, slot);
    else
      vgpu_free(slot, bytes);
  }
  return rc;
}

// -- contexts -------------------------------------------------------------------
// The fixed charge of one context: VTPU_CONTEXT_MIB (MiB, an 'm' suffix
// allowed, as the grant's), else the default.
uint64_t context_bytes() {
  static const uint64_t bytes = [] {
    const char* v = getenv("VTPU_CONTEXT_MIB");
    char* end = nullptr;
    double mib = v && *v ? strtod(v, &end) : -1;
    if (!v || end == v || mib < 0) mib = kDefaultContextMib;
    return (uint64_t)(mib * 1024.0 * 1024.0);
  }();
  return bytes;
}

// Charge a context's footprint on `dev`, then make it with `call`; past the
// grant the driver is not called.
template <class F>
CUresult context_created(const char* what, CUdevice dev, F&& call) {
  if (!g_enforce) return g_managed ? unattached(what) : call();
  int slot = slot_of(dev);
  uint64_t bytes = context_bytes();
  int ok = admit(slot, bytes);
  if (ok == 0) return CUDA_ERROR_OUT_OF_MEMORY;
  CUresult rc = call();
  if (ok == 1) {
    if (rc == CUDA_SUCCESS)
      g_stats[slot].context_bytes.fetch_add(bytes, std::memory_order_relaxed);
    else
      vgpu_free(slot, bytes);
  }
  return rc;
}

std::mutex g_ctx_mu;
std::atomic<bool> g_primary_done[VGPU_MAX_DEVICES];

// -- launches ------------------------------------------------------------------
struct Estimate {
  double ns = 0;        // device time of one launch of this shape
  int samples = 0;      // timed launches folded in
  int pending = 0;      // timed launches not yet read
  int since = 0;        // launches since the last timed one
};

struct Pending {
  CUevent start, end;
  Estimate* est;
  int slot;
  bool busy;        // the device had earlier work when the launch was queued
  bool shared;      // the region's switch was on: a sharer was active
  uint64_t gap_ns;  // the host's time from the start event to the launch
};

struct ThreadState {
  std::unordered_map<uint64_t, Estimate> shapes;
  Pending ring[kPending];
  int head = 0, count = 0;
  std::vector<CUevent> pool[VGPU_MAX_DEVICES];
  uint64_t carry_ns[VGPU_MAX_DEVICES] = {};
  double mean_ns = 0;  // over every timed launch of this thread
};

uint64_t host_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

// Never freed: a thread's events may outlive the context at exit.
thread_local ThreadState* t_state = nullptr;

ThreadState& state() {
  if (!t_state) t_state = new ThreadState;
  return *t_state;
}

uint64_t mix(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdull;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ull;
  return x ^ (x >> 33);
}

uint64_t shape_key(void* fn, unsigned gx, unsigned gy, unsigned gz,
                   unsigned bx, unsigned by, unsigned bz) {
  uint64_t h = mix((uint64_t)(uintptr_t)fn);
  h = mix(h ^ ((uint64_t)gx << 32 | gy));
  h = mix(h ^ ((uint64_t)gz << 32 | bx));
  return mix(h ^ ((uint64_t)by << 32 | bz));
}

CUevent take_event(ThreadState& ts, int slot) {
  std::vector<CUevent>& pool = ts.pool[slot];
  if (!pool.empty()) {
    CUevent e = pool.back();
    pool.pop_back();
    return e;
  }
  CUevent e = nullptr;
  if (g_cu.cuEventCreate(&e, 0) != CUDA_SUCCESS) return nullptr;
  return e;
}

// Fold the timed launches whose end event has completed into their
// estimates; never waits.  A launch queued behind earlier work starts the
// moment its start event completes, so its pair times the kernel alone.  On
// an idle device the start event completes at once and the kernel only
// when the launch reaches the device: the host's time from the one to the
// other is taken off.
void harvest(ThreadState& ts) {
  for (int n = 0; n < 4 && ts.count > 0; ++n) {
    Pending& p = ts.ring[ts.head];
    CUresult q = g_cu.cuEventQuery(p.end);
    if (q == CUDA_ERROR_NOT_READY) return;
    float ms = 0;
    Estimate& e = *p.est;
    if (q == CUDA_SUCCESS &&
        g_cu.cuEventElapsedTime(&ms, p.start, p.end) == CUDA_SUCCESS &&
        ms >= 0) {
      double ns = (double)ms * 1e6;
      if (!p.busy) ns = ns > (double)p.gap_ns ? ns - (double)p.gap_ns : 0;
      if (!e.samples)
        e.ns = ns;
      else if (!p.shared || ns < e.ns)
        e.ns += (ns - e.ns) / 4;
      e.samples++;
      if (!ts.mean_ns)
        ts.mean_ns = ns;
      else if (!p.shared || ns < ts.mean_ns)
        ts.mean_ns += (ns - ts.mean_ns) / 64;
      g_stats[p.slot].samples.fetch_add(1, std::memory_order_relaxed);
      g_stats[p.slot].sampled_us.fetch_add((uint64_t)(ns / 1000),
                                           std::memory_order_relaxed);
    }
    e.pending--;
    ts.pool[p.slot].push_back(p.start);
    ts.pool[p.slot].push_back(p.end);
    ts.head = (ts.head + 1) % kPending;
    ts.count--;
  }
}

// The gate of one launch: `key` identifies its function (or graph) and
// shape, `stream` its stream (`ptsz`: the per-thread default stream is
// meant by 0), `call` the real launch.
template <class F>
CUresult gated_launch(const char* what, uint64_t key, CUstream stream,
                      bool ptsz, F&& call) {
  if (!g_enforce) return g_managed ? unattached(what) : call();
  g_launches.fetch_add(1, std::memory_order_relaxed);
  if (!g_gated) {
    vgpu_region_t* r = vgpu_region();
    if (r) __atomic_store_n(&r->recent_kernel, 3, __ATOMIC_RELAXED);
    return call();
  }
  ThreadState& ts = state();
  int slot = current_slot();
  if (slot < 0) return call();
  DevStats& st = g_stats[slot];
  CUstream on = (ptsz && !stream) ? VGPU_CU_STREAM_PER_THREAD : stream;
  int capturing = CU_STREAM_CAPTURE_STATUS_NONE;
  if (g_cu.cuStreamIsCapturing &&
      g_cu.cuStreamIsCapturing(on, &capturing) == CUDA_SUCCESS &&
      capturing != CU_STREAM_CAPTURE_STATUS_NONE) {
    st.capture_skips.fetch_add(1, std::memory_order_relaxed);
    return call();  // recorded into a graph, run by its launch
  }
  harvest(ts);
  Estimate& e = ts.shapes[key];
  double cost = e.samples ? e.ns : ts.mean_ns ? ts.mean_ns : kUnknownCostNs;
  uint64_t due = ts.carry_ns[slot] + (uint64_t)cost;
  ts.carry_ns[slot] = due % 1000;
  if (due >= 1000) {  // 0 would mean "the limiter's default" to it
    vgpu_rate_acquire(slot, due / 1000);
    st.charged_us.fetch_add(due / 1000, std::memory_order_relaxed);
  } else {
    vgpu_region_t* r = vgpu_region();
    if (r) __atomic_store_n(&r->recent_kernel, 3, __ATOMIC_RELAXED);
  }
  st.gated.fetch_add(1, std::memory_order_relaxed);
  bool timed = (e.samples + e.pending < kFirstSamples ||
                ++e.since >= kResample) &&
               ts.count < kPending;
  CUevent a = timed ? take_event(ts, slot) : nullptr;
  CUevent b = a ? take_event(ts, slot) : nullptr;
  if (a && (!b || g_cu.cuEventRecord(a, on) != CUDA_SUCCESS)) {
    ts.pool[slot].push_back(a);
    if (b) ts.pool[slot].push_back(b);
    a = b = nullptr;
  }
  uint64_t t0 = a ? host_ns() : 0;
  CUresult rc = call();
  if (a) {
    uint64_t gap = host_ns() - t0;
    if (rc == CUDA_SUCCESS && g_cu.cuEventRecord(b, on) == CUDA_SUCCESS) {
      // Still pending after the launch was queued: the device was busy.
      bool busy = g_cu.cuEventQuery(a) == CUDA_ERROR_NOT_READY;
      vgpu_region_t* r = vgpu_region();
      bool shared =
          r && __atomic_load_n(&r->utilization_switch, __ATOMIC_RELAXED);
      ts.ring[(ts.head + ts.count) % kPending] =
          Pending{a, b, &e, slot, busy, shared, gap};
      ts.count++;
      e.pending++;
      e.since = 0;
    } else {
      ts.pool[slot].push_back(a);
      ts.pool[slot].push_back(b);
    }
  }
  return rc;
}

// -- NVML device -> region slot -------------------------------------------------
int nvml_slot(nvmlDevice_t d) {
  vgpu_region_t* r = vgpu_region();
  if (!r) return -1;
  load_nvml();
  bool named = false;
  for (int i = 0; i < r->num_devices && i < VGPU_MAX_DEVICES; ++i)
    named = named || r->uuids[i][0];
  if (named) {
    char uuid[96];
    if (!g_nvml.GetUUID || g_nvml.GetUUID(d, uuid, sizeof(uuid)) != 0)
      return -1;
    for (int i = 0; i < r->num_devices && i < VGPU_MAX_DEVICES; ++i)
      if (!strcmp(r->uuids[i], uuid)) return i;
    return -1;
  }
  unsigned int index = 0;
  if (!g_nvml.GetIndex || g_nvml.GetIndex(d, &index) != 0) return -1;
  return (int)index < r->num_devices ? (int)index : -1;
}

// The grant and the pod's use on `slot`; false when uncapped.
bool virtual_memory(int slot, uint64_t* limit, uint64_t* used) {
  if (!g_enforce || slot < 0) return false;
  *limit = vgpu_get_limit(slot);
  if (!*limit) return false;
  *used = vgpu_get_used(slot);
  return true;
}

// The versioned name the driver maps (base name, CUDA version, flags) to.
std::string versioned_name(const char* symbol, int version,
                           cuuint64_t flags) {
  static const struct {
    const char* base;
    int min_version;
    const char* name;
  } kVersions[] = {
      {"cuMemAlloc", 3020, "cuMemAlloc_v2"},
      {"cuMemAllocPitch", 3020, "cuMemAllocPitch_v2"},
      {"cuMemFree", 3020, "cuMemFree_v2"},
      {"cuMemGetInfo", 3020, "cuMemGetInfo_v2"},
      {"cuDeviceTotalMem", 3020, "cuDeviceTotalMem_v2"},
      {"cuCtxCreate", 12050, "cuCtxCreate_v4"},
      {"cuCtxCreate", 11040, "cuCtxCreate_v3"},
      {"cuCtxCreate", 3020, "cuCtxCreate_v2"},
      {"cuGetProcAddress", 12000, "cuGetProcAddress_v2"},
  };
  static const char* const kPerThread[] = {
      "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel",
      "cuGraphLaunch", "cuMemAllocAsync", "cuMemAllocFromPoolAsync",
      "cuMemFreeAsync"};
  std::string want = symbol;
  for (const auto& v : kVersions)
    if (want == v.base && version >= v.min_version) {
      want = v.name;
      break;
    }
  if (flags & CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM)
    for (const char* p : kPerThread)
      if (want == p) return want + "_ptsz";
  return want;
}

// The hook of what a lookup of (`symbol`, `version`, `flags`) returned as
// `p`, with `p` its real entry point; `p` itself where nothing is hooked.
void* hook_for(const char* symbol, void* p, int version, cuuint64_t flags) {
  if (!p || !symbol) return p;
  int id = hook_id(versioned_name(symbol, version, flags).c_str());
  if (id < 0 || id >= H_NVML_FIRST_) return p;
  set_real(id, p);
  return kHooks[id].fn;
}

std::string hook_names() {
  std::string s;
  for (int i = 0; i < H_COUNT; ++i) {
    if (!s.empty()) s += ",";
    s += kHooks[i].name;
  }
  return s;
}

}  // namespace

// -- lifecycle ---------------------------------------------------------------------
__attribute__((constructor)) static void vgpu_interposer_init(void) {
  if (getenv("VTPU_DISABLE")) return;
  const char* cache = getenv("CUDA_DEVICE_MEMORY_SHARED_CACHE");
  if (!cache || !*cache) return;
  g_managed = true;
  int rc = vgpu_init();
  if (rc != 0) {
    fprintf(stderr, "vgpu-interposer: cannot attach the shared region %s: "
            "%s\n", cache, strerror(-rc));
    return;
  }
  vgpu_region_t* r = vgpu_region();
  const char* policy = getenv("GPU_CORE_UTILIZATION_POLICY");
  bool disabled = policy && !strcmp(policy, "disable");
  for (int i = 0; i < VGPU_MAX_DEVICES; ++i)
    if (r->sm_limit[i] > 0 && r->sm_limit[i] < 100) g_gated = !disabled;
  if (r->qos_class >= 0) g_gated = true;
  g_enforce = true;
}

__attribute__((destructor)) static void vgpu_interposer_fini(void) {
  if (!g_enforce) return;
  g_enforce = false;
  g_managed = false;  // late calls (static destructors) pass through
  vgpu_shutdown();
}

extern "C" {

// -- symbol lookup -----------------------------------------------------------------
void* dlsym(void* handle, const char* name) {
  dlsym_fn real = real_dlsym();
  if (!real) return nullptr;
  void* p = real(handle, name);
  int id = hook_id(name);
  if (id < 0) return p;
  if (!p) return nullptr;  // the library has no such symbol
  set_real(id, p);
  return kHooks[id].fn;
}

CUresult cuGetProcAddress_v2(const char* symbol, void** pfn, int version,
                             cuuint64_t flags,
                             CUdriverProcAddressQueryResult* status) {
  auto real = REAL(cuGetProcAddress_v2);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  CUresult rc = real(symbol, pfn, version, flags, status);
  if (rc == CUDA_SUCCESS && pfn) *pfn = hook_for(symbol, *pfn, version, flags);
  return rc;
}

CUresult cuGetProcAddress(const char* symbol, void** pfn, int version,
                          cuuint64_t flags) {
  auto real = REAL(cuGetProcAddress);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  CUresult rc = real(symbol, pfn, version, flags);
  if (rc == CUDA_SUCCESS && pfn) *pfn = hook_for(symbol, *pfn, version, flags);
  return rc;
}

CUresult cuInit(unsigned int flags) {
  auto real = REAL(cuInit);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  if (g_managed && !g_enforce) {
    fprintf(stderr,
            "vgpu-interposer: cuInit refused: the container is managed "
            "(CUDA_DEVICE_MEMORY_SHARED_CACHE=%s) but its shared region is "
            "not attached\n",
            getenv("CUDA_DEVICE_MEMORY_SHARED_CACHE"));
    return CUDA_ERROR_OPERATING_SYSTEM;
  }
  return real(flags);
}

// -- memory ----------------------------------------------------------------------------
CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t bytes) {
  auto real = REAL(cuMemAlloc_v2);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return charged_alloc("cuMemAlloc_v2", dptr, bytes,
                       [&] { return real(dptr, bytes); });
}

CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t bytes,
                           unsigned int flags) {
  auto real = REAL(cuMemAllocManaged);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return charged_alloc("cuMemAllocManaged", dptr, bytes,
                       [&] { return real(dptr, bytes, flags); });
}

CUresult cuMemAllocAsync(CUdeviceptr* dptr, size_t bytes, CUstream s) {
  auto real = REAL(cuMemAllocAsync);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return charged_alloc("cuMemAllocAsync", dptr, bytes,
                       [&] { return real(dptr, bytes, s); });
}

CUresult cuMemAllocAsync_ptsz(CUdeviceptr* dptr, size_t bytes, CUstream s) {
  auto real = REAL(cuMemAllocAsync_ptsz);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return charged_alloc("cuMemAllocAsync_ptsz", dptr, bytes,
                       [&] { return real(dptr, bytes, s); });
}

CUresult cuMemAllocFromPoolAsync(CUdeviceptr* dptr, size_t bytes,
                                 CUmemoryPool pool, CUstream s) {
  auto real = REAL(cuMemAllocFromPoolAsync);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return charged_alloc("cuMemAllocFromPoolAsync", dptr, bytes,
                       [&] { return real(dptr, bytes, pool, s); });
}

CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr* dptr, size_t bytes,
                                      CUmemoryPool pool, CUstream s) {
  auto real = REAL(cuMemAllocFromPoolAsync_ptsz);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return charged_alloc("cuMemAllocFromPoolAsync_ptsz", dptr, bytes,
                       [&] { return real(dptr, bytes, pool, s); });
}

CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pitch, size_t width,
                            size_t height, unsigned int elem) {
  auto real = REAL(cuMemAllocPitch_v2);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  if (!g_enforce)
    return g_managed ? unattached("cuMemAllocPitch_v2")
                     : real(dptr, pitch, width, height, elem);
  // The pitch is the driver's choice: allocate, then charge what it took.
  CUresult rc = real(dptr, pitch, width, height, elem);
  if (rc != CUDA_SUCCESS || !dptr || !pitch) return rc;
  uint64_t bytes = (uint64_t)*pitch * height;
  int slot = current_slot();
  int ok = admit(slot, bytes);
  if (ok == 0) {
    auto free_real = REAL(cuMemFree_v2);
    if (free_real) free_real(*dptr);
    *dptr = 0;
    return CUDA_ERROR_OUT_OF_MEMORY;
  }
  if (ok == 1) remember(g_ptrs, *dptr, bytes, slot);
  return rc;
}

CUresult cuMemFree_v2(CUdeviceptr dptr) {
  auto real = REAL(cuMemFree_v2);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  CUresult rc = real(dptr);
  if (rc == CUDA_SUCCESS && g_enforce) forget(g_ptrs, dptr);
  return rc;
}

CUresult cuMemFreeAsync(CUdeviceptr dptr, CUstream s) {
  auto real = REAL(cuMemFreeAsync);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  CUresult rc = real(dptr, s);
  if (rc == CUDA_SUCCESS && g_enforce) forget(g_ptrs, dptr);
  return rc;
}

CUresult cuMemFreeAsync_ptsz(CUdeviceptr dptr, CUstream s) {
  auto real = REAL(cuMemFreeAsync_ptsz);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  CUresult rc = real(dptr, s);
  if (rc == CUDA_SUCCESS && g_enforce) forget(g_ptrs, dptr);
  return rc;
}

CUresult cuMemCreate(CUmemGenericAllocationHandle* handle, size_t bytes,
                     const CUmemAllocationProp* prop,
                     unsigned long long flags) {
  auto real = REAL(cuMemCreate);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  if (!g_enforce)
    return g_managed ? unattached("cuMemCreate")
                     : real(handle, bytes, prop, flags);
  if (!prop || prop->location_type != CU_MEM_LOCATION_TYPE_DEVICE)
    return real(handle, bytes, prop, flags);  // host memory: not charged
  int slot = slot_of(prop->location_id);
  int ok = admit(slot, bytes);
  if (ok == 0) return CUDA_ERROR_OUT_OF_MEMORY;
  CUresult rc = real(handle, bytes, prop, flags);
  if (ok == 1) {
    if (rc == CUDA_SUCCESS && handle)
      remember(g_handles, *handle, bytes, slot);
    else
      vgpu_free(slot, bytes);
  }
  return rc;
}

CUresult cuMemRelease(CUmemGenericAllocationHandle handle) {
  auto real = REAL(cuMemRelease);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  CUresult rc = real(handle);
  if (rc == CUDA_SUCCESS && g_enforce) forget(g_handles, handle);
  return rc;
}

CUresult cuMemGetInfo_v2(size_t* free_bytes, size_t* total) {
  auto real = REAL(cuMemGetInfo_v2);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  CUresult rc = real(free_bytes, total);
  uint64_t limit, used;
  if (rc == CUDA_SUCCESS && virtual_memory(current_slot(), &limit, &used)) {
    uint64_t left = used < limit ? limit - used : 0;
    if (total) *total = limit;
    if (free_bytes && *free_bytes > left) *free_bytes = left;
  }
  return rc;
}

CUresult cuDeviceTotalMem_v2(size_t* bytes, CUdevice dev) {
  auto real = REAL(cuDeviceTotalMem_v2);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  CUresult rc = real(bytes, dev);
  uint64_t limit, used;
  if (rc == CUDA_SUCCESS && bytes &&
      virtual_memory(slot_of(dev), &limit, &used))
    *bytes = limit;
  return rc;
}

// -- contexts ------------------------------------------------------------------------------
CUresult cuDevicePrimaryCtxRetain(CUcontext* pctx, CUdevice dev) {
  auto real = REAL(cuDevicePrimaryCtxRetain);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  if (!g_enforce)
    return g_managed ? unattached("cuDevicePrimaryCtxRetain") : real(pctx, dev);
  int slot = slot_of(dev);
  if (slot < 0 || g_primary_done[slot].load(std::memory_order_acquire))
    return real(pctx, dev);
  std::lock_guard<std::mutex> g(g_ctx_mu);  // one charge per device
  if (g_primary_done[slot].load(std::memory_order_relaxed))
    return real(pctx, dev);
  CUresult rc = context_created("cuDevicePrimaryCtxRetain", dev,
                                [&] { return real(pctx, dev); });
  if (rc == CUDA_SUCCESS)
    g_primary_done[slot].store(true, std::memory_order_release);
  return rc;
}

CUresult cuCtxCreate_v2(CUcontext* pctx, unsigned int flags, CUdevice dev) {
  auto real = REAL(cuCtxCreate_v2);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return context_created("cuCtxCreate_v2", dev,
                         [&] { return real(pctx, flags, dev); });
}

CUresult cuCtxCreate_v3(CUcontext* pctx, void* params, int n,
                        unsigned int flags, CUdevice dev) {
  auto real = REAL(cuCtxCreate_v3);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return context_created("cuCtxCreate_v3", dev,
                         [&] { return real(pctx, params, n, flags, dev); });
}

CUresult cuCtxCreate_v4(CUcontext* pctx, void* params, unsigned int flags,
                        CUdevice dev) {
  auto real = REAL(cuCtxCreate_v4);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return context_created("cuCtxCreate_v4", dev,
                         [&] { return real(pctx, params, flags, dev); });
}

// -- launches ---------------------------------------------------------------------------
#define VGPU_LAUNCH_KEY(fn) shape_key((void*)(fn), gx, gy, gz, bx, by, bz)

CUresult cuLaunchKernel(VGPU_LAUNCH_ARGS, void** extra) {
  auto real = REAL(cuLaunchKernel);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return gated_launch("cuLaunchKernel", VGPU_LAUNCH_KEY(f), s, false, [&] {
    return real(f, gx, gy, gz, bx, by, bz, shm, s, params, extra);
  });
}

CUresult cuLaunchKernel_ptsz(VGPU_LAUNCH_ARGS, void** extra) {
  auto real = REAL(cuLaunchKernel_ptsz);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return gated_launch("cuLaunchKernel_ptsz", VGPU_LAUNCH_KEY(f), s, true, [&] {
                        return real(f, gx, gy, gz, bx, by, bz, shm, s, params,
                                    extra);
                      });
}

CUresult cuLaunchCooperativeKernel(VGPU_LAUNCH_ARGS) {
  auto real = REAL(cuLaunchCooperativeKernel);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return gated_launch("cuLaunchCooperativeKernel", VGPU_LAUNCH_KEY(f), s,
                      false, [&] {
                        return real(f, gx, gy, gz, bx, by, bz, shm, s,
                                    params);
                      });
}

CUresult cuLaunchCooperativeKernel_ptsz(VGPU_LAUNCH_ARGS) {
  auto real = REAL(cuLaunchCooperativeKernel_ptsz);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return gated_launch("cuLaunchCooperativeKernel_ptsz", VGPU_LAUNCH_KEY(f),
                      s, true, [&] {
                        return real(f, gx, gy, gz, bx, by, bz, shm, s,
                                    params);
                      });
}

CUresult cuLaunchKernelEx(const CUlaunchConfig* cfg, CUfunction f,
                          void** params, void** extra) {
  auto real = REAL(cuLaunchKernelEx);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  if (!cfg) return real(cfg, f, params, extra);
  return gated_launch(
      "cuLaunchKernelEx",
      shape_key(f, cfg->gridDimX, cfg->gridDimY, cfg->gridDimZ,
                cfg->blockDimX, cfg->blockDimY, cfg->blockDimZ),
      cfg->hStream, false, [&] { return real(cfg, f, params, extra); });
}

CUresult cuLaunchKernelEx_ptsz(const CUlaunchConfig* cfg, CUfunction f,
                               void** params, void** extra) {
  auto real = REAL(cuLaunchKernelEx_ptsz);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  if (!cfg) return real(cfg, f, params, extra);
  return gated_launch(
      "cuLaunchKernelEx_ptsz",
      shape_key(f, cfg->gridDimX, cfg->gridDimY, cfg->gridDimZ,
                cfg->blockDimX, cfg->blockDimY, cfg->blockDimZ),
      cfg->hStream, true, [&] { return real(cfg, f, params, extra); });
}

CUresult cuGraphLaunch(CUgraphExec g, CUstream s) {
  auto real = REAL(cuGraphLaunch);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return gated_launch("cuGraphLaunch", shape_key(g, 0, 0, 0, 0, 0, 0), s,
                      false, [&] { return real(g, s); });
}

CUresult cuGraphLaunch_ptsz(CUgraphExec g, CUstream s) {
  auto real = REAL(cuGraphLaunch_ptsz);
  if (!real) return CUDA_ERROR_NOT_FOUND;
  return gated_launch("cuGraphLaunch_ptsz", shape_key(g, 0, 0, 0, 0, 0, 0),
                      s, true, [&] { return real(g, s); });
}

// -- NVML --------------------------------------------------------------------------------
nvmlReturn_t nvmlDeviceGetMemoryInfo(nvmlDevice_t d, nvmlMemory_t* m) {
  auto real = REAL(nvmlDeviceGetMemoryInfo);
  if (!real) return kNvmlFunctionNotFound;
  nvmlReturn_t rc = real(d, m);
  uint64_t limit, used;
  if (rc == NVML_SUCCESS && m && g_enforce &&
      virtual_memory(nvml_slot(d), &limit, &used)) {
    m->total = limit;
    m->used = used;
    m->free = used < limit ? limit - used : 0;
  }
  return rc;
}

nvmlReturn_t nvmlDeviceGetMemoryInfo_v2(nvmlDevice_t d, nvmlMemory_v2_t* m) {
  auto real = REAL(nvmlDeviceGetMemoryInfo_v2);
  if (!real) return kNvmlFunctionNotFound;
  nvmlReturn_t rc = real(d, m);
  uint64_t limit, used;
  if (rc == NVML_SUCCESS && m && g_enforce &&
      virtual_memory(nvml_slot(d), &limit, &used)) {
    m->total = limit;
    m->reserved = 0;
    m->used = used;
    m->free = used < limit ? limit - used : 0;
  }
  return rc;
}

// -- this library's own surface ---------------------------------------------------------------
// 1 while the interposer enforces (attached to a region), else 0.  The
// port's Python shim looks this symbol up in its own process and stands
// down when it answers 1.
int vgpu_interposer_active(void) { return g_enforce ? 1 : 0; }

// The hooked names, comma-separated.
const char* vgpu_interposer_hooks(void) {
  static const std::string names = hook_names();
  return names.c_str();
}

// Counters of device `dev`, in this order: launches through the hooks (all
// devices), gated launches, charged us, timed launches, their device us,
// context bytes charged, live allocation bytes charged, refusals, launches
// skipped while capturing.  Returns how many were written.
int vgpu_interposer_stats(int dev, uint64_t* out, int n) {
  if (dev < 0 || dev >= VGPU_MAX_DEVICES || !out) return 0;
  const DevStats& s = g_stats[dev];
  const uint64_t v[] = {g_launches.load(),      s.gated.load(),
                        s.charged_us.load(),    s.samples.load(),
                        s.sampled_us.load(),    s.context_bytes.load(),
                        s.alloc_bytes.load(),   s.refusals.load(),
                        s.capture_skips.load()};
  int k = 0;
  for (; k < n && k < (int)(sizeof(v) / sizeof(v[0])); ++k) out[k] = v[k];
  return k;
}

}  // extern "C"
