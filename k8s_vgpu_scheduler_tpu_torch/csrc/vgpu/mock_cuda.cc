// Mock CUDA driver and NVML: a fake native backend for the driver-API
// interposer's CPU tests, the counterpart of the TPU library's mock PJRT
// plugin (mock_pjrt.cc).
//
// Built as build/mock_cuda-<hash>/libcuda.so.1, with libnvidia-ml.so.1
// beside it as a link to the same file (so the two share one state, as the
// real NVML reads the real driver's).  It implements what the interposer
// hooks and calls, and what the C test driver calls:
//
//   - two fake devices (MOCK_TOTAL_MIB each, default 81079) with
//     malloc-backed allocations (cuMemAlloc_v2, _AllocPitch_v2,
//     _AllocManaged, _AllocAsync, _AllocFromPoolAsync, the VMM pair
//     cuMemCreate/cuMemRelease), refused with CUDA_ERROR_OUT_OF_MEMORY only
//     past the physical size;
//   - cuGetProcAddress and cuGetProcAddress_v2, which return its own entry
//     points by name, CUDA version and per-thread-stream flag, as the
//     driver does (cuMemAlloc at 3020 or later -> cuMemAlloc_v2,
//     cuLaunchKernel with the per-thread flag -> cuLaunchKernel_ptsz); with
//     MOCK_INTERNAL_ENTRIES set, those two lookups return internal entry
//     points instead of the exported symbols, as a driver may;
//   - launches (cuLaunchKernel, _Ex, _Cooperative, cuGraphLaunch and their
//     _ptsz forms) that burn MOCK_EXEC_US of wall time (default 0) and
//     advance a mock device clock by the same amount, which the events
//     (cuEventRecord, cuEventElapsedTime) read; an event completes one
//     query after it is recorded, as on a device that runs a little behind
//     the host;
//   - cuModuleLoadData and cuModuleGetFunction, which hand out handles;
//   - a context footprint: the first cuDevicePrimaryCtxRetain on a device,
//     and every cuCtxCreate, take MOCK_CTX_BYTES (default 0) from its free
//     memory;
//   - cuMemGetInfo_v2 and NVML's nvmlDeviceGetMemoryInfo(_v2), which report
//     the physical total and what this process holds.
//
// Calls into the mock are counted per entry point (mock_cuda_calls) so a
// test can tell a hooked call from one that passed through.

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include "cuda_types.h"

namespace {

constexpr int kDevices = 2;
constexpr uint64_t kMiB = 1ull << 20;

std::mutex g_mu;
bool g_init = false;
uint64_t g_used[kDevices];     // bytes this process holds on each device
int g_primary_refs[kDevices];  // primary context retain count
bool g_primary_charged[kDevices];
int g_ctx_obj[kDevices * 64];  // identities of created contexts
int g_ctx_next = kDevices;     // [0, kDevices) are the primary contexts
int g_ctx_dev[kDevices * 64];
std::atomic<uint64_t> g_clock_ns{1};
struct Block {
  void* mem;
  uint64_t bytes;
  int dev;
};
std::map<CUdeviceptr, Block> g_ptrs;
std::map<CUmemGenericAllocationHandle, Block> g_handles;
CUmemGenericAllocationHandle g_next_handle = 1;
std::map<std::string, uint64_t> g_calls;
thread_local std::vector<CUcontext> t_ctx;  // back() is current

struct MockEvent {
  uint64_t t_ns;
  int queries;  // since it was recorded
};

uint64_t env_u64(const char* name, uint64_t fallback) {
  const char* v = getenv(name);
  return v && *v ? strtoull(v, nullptr, 10) : fallback;
}

uint64_t total_bytes() { return env_u64("MOCK_TOTAL_MIB", 81079) * kMiB; }

void count(const char* name) {
  std::lock_guard<std::mutex> g(g_mu);
  g_calls[name]++;
}

int current_dev() {
  if (t_ctx.empty() || !t_ctx.back()) return -1;
  int idx = (int)(reinterpret_cast<int*>(t_ctx.back()) - g_ctx_obj);
  return g_ctx_dev[idx];
}

// Take `bytes` on `dev` unless that passes the physical size.
bool take(int dev, uint64_t bytes) {
  if (g_used[dev] + bytes > total_bytes()) return false;
  g_used[dev] += bytes;
  return true;
}

CUresult alloc(int dev, CUdeviceptr* dptr, uint64_t bytes) {
  if (!dptr) return CUDA_ERROR_INVALID_VALUE;
  if (dev < 0) return CUDA_ERROR_INVALID_CONTEXT;
  std::lock_guard<std::mutex> g(g_mu);
  if (!take(dev, bytes)) return CUDA_ERROR_OUT_OF_MEMORY;
  // Untouched pages: a large block costs address space only.
  void* mem = malloc(bytes ? bytes : 1);
  *dptr = (CUdeviceptr)(uintptr_t)mem;
  g_ptrs[*dptr] = Block{mem, bytes, dev};
  return CUDA_SUCCESS;
}

CUresult release(CUdeviceptr dptr) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_ptrs.find(dptr);
  if (it == g_ptrs.end()) return CUDA_ERROR_INVALID_VALUE;
  g_used[it->second.dev] -= it->second.bytes;
  free(it->second.mem);
  g_ptrs.erase(it);
  return CUDA_SUCCESS;
}

CUresult launch(void* fn) {
  if (current_dev() < 0 || !fn) return CUDA_ERROR_INVALID_CONTEXT;
  uint64_t us = env_u64("MOCK_EXEC_US", 0);
  if (us) usleep((useconds_t)us);
  g_clock_ns.fetch_add(us * 1000);
  return CUDA_SUCCESS;
}

CUresult make_context(CUcontext* pctx, CUdevice dev) {
  if (!g_init) return CUDA_ERROR_NOT_INITIALIZED;
  if (!pctx || dev < 0 || dev >= kDevices) return CUDA_ERROR_INVALID_VALUE;
  std::lock_guard<std::mutex> g(g_mu);
  if (g_ctx_next >= kDevices * 64) return CUDA_ERROR_OUT_OF_MEMORY;
  if (!take(dev, env_u64("MOCK_CTX_BYTES", 0))) return CUDA_ERROR_OUT_OF_MEMORY;
  int idx = g_ctx_next++;
  g_ctx_dev[idx] = dev;
  *pctx = reinterpret_cast<CUcontext>(&g_ctx_obj[idx]);
  return CUDA_SUCCESS;
}

void uuid_of(int dev, CUuuid* out) {
  memset(out->bytes, 0, sizeof(out->bytes));
  out->bytes[15] = (char)(dev + 1);
}

std::string uuid_string(int dev) {
  char buf[64];
  snprintf(buf, sizeof(buf), "GPU-00000000-0000-0000-0000-0000000000%02x",
           dev + 1);
  return buf;
}

}  // namespace

extern "C" {

// -- introspection for the tests (not CUDA API) ------------------------------
uint64_t mock_cuda_calls(const char* name) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_calls.find(name);
  return it == g_calls.end() ? 0 : it->second;
}

// -- initialization, devices, contexts ---------------------------------------
CUresult cuInit(unsigned int) {
  count("cuInit");
  g_init = true;
  return CUDA_SUCCESS;
}

CUresult cuDeviceGetCount(int* n) {
  if (!g_init) return CUDA_ERROR_NOT_INITIALIZED;
  *n = kDevices;
  return CUDA_SUCCESS;
}

CUresult cuDeviceGetUuid(CUuuid* u, CUdevice d) {
  if (!u || d < 0 || d >= kDevices) return CUDA_ERROR_INVALID_VALUE;
  uuid_of(d, u);
  return CUDA_SUCCESS;
}

CUresult cuDeviceTotalMem_v2(size_t* bytes, CUdevice d) {
  count("cuDeviceTotalMem_v2");
  if (!bytes || d < 0 || d >= kDevices) return CUDA_ERROR_INVALID_VALUE;
  *bytes = total_bytes();
  return CUDA_SUCCESS;
}

CUresult cuDevicePrimaryCtxRetain(CUcontext* pctx, CUdevice dev) {
  count("cuDevicePrimaryCtxRetain");
  if (!g_init) return CUDA_ERROR_NOT_INITIALIZED;
  if (!pctx || dev < 0 || dev >= kDevices) return CUDA_ERROR_INVALID_VALUE;
  std::lock_guard<std::mutex> g(g_mu);
  if (!g_primary_charged[dev]) {
    if (!take(dev, env_u64("MOCK_CTX_BYTES", 0)))
      return CUDA_ERROR_OUT_OF_MEMORY;
    g_primary_charged[dev] = true;
  }
  g_primary_refs[dev]++;
  g_ctx_dev[dev] = dev;
  *pctx = reinterpret_cast<CUcontext>(&g_ctx_obj[dev]);
  return CUDA_SUCCESS;
}

CUresult cuDevicePrimaryCtxRelease_v2(CUdevice dev) {
  if (dev < 0 || dev >= kDevices) return CUDA_ERROR_INVALID_VALUE;
  std::lock_guard<std::mutex> g(g_mu);
  if (g_primary_refs[dev] > 0 && --g_primary_refs[dev] == 0 &&
      g_primary_charged[dev]) {
    g_used[dev] -= env_u64("MOCK_CTX_BYTES", 0);
    g_primary_charged[dev] = false;
  }
  return CUDA_SUCCESS;
}

CUresult cuCtxCreate_v2(CUcontext* pctx, unsigned int, CUdevice dev) {
  count("cuCtxCreate_v2");
  CUresult rc = make_context(pctx, dev);
  if (rc == CUDA_SUCCESS) t_ctx.push_back(*pctx);
  return rc;
}

CUresult cuCtxCreate_v3(CUcontext* pctx, void*, int, unsigned int flags,
                        CUdevice dev) {
  count("cuCtxCreate_v3");
  return cuCtxCreate_v2(pctx, flags, dev);
}

CUresult cuCtxCreate_v4(CUcontext* pctx, void*, unsigned int flags,
                        CUdevice dev) {
  count("cuCtxCreate_v4");
  return cuCtxCreate_v2(pctx, flags, dev);
}

CUresult cuCtxSetCurrent(CUcontext ctx) {
  if (t_ctx.empty())
    t_ctx.push_back(ctx);
  else
    t_ctx.back() = ctx;
  return CUDA_SUCCESS;
}

CUresult cuCtxGetCurrent(CUcontext* ctx) {
  *ctx = t_ctx.empty() ? nullptr : t_ctx.back();
  return CUDA_SUCCESS;
}

CUresult cuCtxGetDevice(CUdevice* d) {
  int dev = current_dev();
  if (dev < 0) return CUDA_ERROR_INVALID_CONTEXT;
  *d = dev;
  return CUDA_SUCCESS;
}

CUresult cuCtxPushCurrent_v2(CUcontext ctx) {
  t_ctx.push_back(ctx);
  return CUDA_SUCCESS;
}

CUresult cuCtxPopCurrent_v2(CUcontext* ctx) {
  if (t_ctx.empty()) return CUDA_ERROR_INVALID_CONTEXT;
  if (ctx) *ctx = t_ctx.back();
  t_ctx.pop_back();
  return CUDA_SUCCESS;
}

CUresult cuCtxSynchronize(void) { return CUDA_SUCCESS; }

// -- memory -------------------------------------------------------------------
CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t bytes) {
  count("cuMemAlloc_v2");
  return alloc(current_dev(), dptr, bytes);
}

CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pitch, size_t width,
                            size_t height, unsigned int) {
  count("cuMemAllocPitch_v2");
  if (!pitch) return CUDA_ERROR_INVALID_VALUE;
  *pitch = (width + 511) / 512 * 512;
  return alloc(current_dev(), dptr, (uint64_t)*pitch * height);
}

CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t bytes, unsigned int) {
  count("cuMemAllocManaged");
  return alloc(current_dev(), dptr, bytes);
}

CUresult cuMemFree_v2(CUdeviceptr dptr) {
  count("cuMemFree_v2");
  return release(dptr);
}

CUresult cuMemAllocAsync(CUdeviceptr* dptr, size_t bytes, CUstream) {
  count("cuMemAllocAsync");
  return alloc(current_dev(), dptr, bytes);
}

CUresult cuMemAllocAsync_ptsz(CUdeviceptr* dptr, size_t bytes, CUstream) {
  count("cuMemAllocAsync_ptsz");
  return alloc(current_dev(), dptr, bytes);
}

CUresult cuMemAllocFromPoolAsync(CUdeviceptr* dptr, size_t bytes,
                                 CUmemoryPool, CUstream) {
  count("cuMemAllocFromPoolAsync");
  return alloc(current_dev(), dptr, bytes);
}

CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr* dptr, size_t bytes,
                                      CUmemoryPool, CUstream) {
  count("cuMemAllocFromPoolAsync_ptsz");
  return alloc(current_dev(), dptr, bytes);
}

CUresult cuMemFreeAsync(CUdeviceptr dptr, CUstream) {
  count("cuMemFreeAsync");
  return release(dptr);
}

CUresult cuMemFreeAsync_ptsz(CUdeviceptr dptr, CUstream) {
  count("cuMemFreeAsync_ptsz");
  return release(dptr);
}

CUresult cuMemCreate(CUmemGenericAllocationHandle* handle, size_t bytes,
                     const CUmemAllocationProp* prop, unsigned long long) {
  count("cuMemCreate");
  if (!handle || !prop) return CUDA_ERROR_INVALID_VALUE;
  int dev = prop->location_id;
  if (dev < 0 || dev >= kDevices) return CUDA_ERROR_INVALID_VALUE;
  std::lock_guard<std::mutex> g(g_mu);
  if (prop->location_type == CU_MEM_LOCATION_TYPE_DEVICE &&
      !take(dev, bytes))
    return CUDA_ERROR_OUT_OF_MEMORY;
  *handle = g_next_handle++;
  g_handles[*handle] = Block{
      nullptr,
      prop->location_type == CU_MEM_LOCATION_TYPE_DEVICE ? bytes : 0, dev};
  return CUDA_SUCCESS;
}

CUresult cuMemRelease(CUmemGenericAllocationHandle handle) {
  count("cuMemRelease");
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_handles.find(handle);
  if (it == g_handles.end()) return CUDA_ERROR_INVALID_VALUE;
  g_used[it->second.dev] -= it->second.bytes;
  g_handles.erase(it);
  return CUDA_SUCCESS;
}

CUresult cuMemGetInfo_v2(size_t* free_bytes, size_t* total) {
  count("cuMemGetInfo_v2");
  int dev = current_dev();
  if (dev < 0) return CUDA_ERROR_INVALID_CONTEXT;
  std::lock_guard<std::mutex> g(g_mu);
  if (free_bytes) *free_bytes = total_bytes() - g_used[dev];
  if (total) *total = total_bytes();
  return CUDA_SUCCESS;
}

// -- launches, events, streams ------------------------------------------------
#define MOCK_LAUNCH_ARGS                                                  \
  CUfunction f, unsigned int, unsigned int, unsigned int, unsigned int,   \
      unsigned int, unsigned int, unsigned int, CUstream, void**

CUresult cuLaunchKernel(MOCK_LAUNCH_ARGS, void**) {
  count("cuLaunchKernel");
  return launch(f);
}

CUresult cuLaunchKernel_ptsz(MOCK_LAUNCH_ARGS, void**) {
  count("cuLaunchKernel_ptsz");
  return launch(f);
}

CUresult cuLaunchCooperativeKernel(MOCK_LAUNCH_ARGS) {
  count("cuLaunchCooperativeKernel");
  return launch(f);
}

CUresult cuLaunchCooperativeKernel_ptsz(MOCK_LAUNCH_ARGS) {
  count("cuLaunchCooperativeKernel_ptsz");
  return launch(f);
}

CUresult cuLaunchKernelEx(const CUlaunchConfig*, CUfunction f, void**,
                          void**) {
  count("cuLaunchKernelEx");
  return launch(f);
}

CUresult cuLaunchKernelEx_ptsz(const CUlaunchConfig*, CUfunction f, void**,
                               void**) {
  count("cuLaunchKernelEx_ptsz");
  return launch(f);
}

CUresult cuGraphLaunch(CUgraphExec g, CUstream) {
  count("cuGraphLaunch");
  return launch(g);
}

CUresult cuGraphLaunch_ptsz(CUgraphExec g, CUstream) {
  count("cuGraphLaunch_ptsz");
  return launch(g);
}

CUresult cuEventCreate(CUevent* ev, unsigned int) {
  if (!ev) return CUDA_ERROR_INVALID_VALUE;
  *ev = reinterpret_cast<CUevent>(new MockEvent{0, 0});
  return CUDA_SUCCESS;
}

CUresult cuEventDestroy_v2(CUevent ev) {
  delete reinterpret_cast<MockEvent*>(ev);
  return CUDA_SUCCESS;
}

CUresult cuEventRecord(CUevent ev, CUstream) {
  if (!ev) return CUDA_ERROR_INVALID_VALUE;
  reinterpret_cast<MockEvent*>(ev)->t_ns = g_clock_ns.load();
  reinterpret_cast<MockEvent*>(ev)->queries = 0;
  return CUDA_SUCCESS;
}

CUresult cuEventRecord_ptsz(CUevent ev, CUstream s) {
  return cuEventRecord(ev, s);
}

CUresult cuEventQuery(CUevent ev) {
  if (!ev) return CUDA_ERROR_INVALID_VALUE;
  return reinterpret_cast<MockEvent*>(ev)->queries++ ? CUDA_SUCCESS
                                                     : CUDA_ERROR_NOT_READY;
}

CUresult cuEventSynchronize(CUevent ev) {
  if (!ev) return CUDA_ERROR_INVALID_VALUE;
  reinterpret_cast<MockEvent*>(ev)->queries = 1;
  return CUDA_SUCCESS;
}

CUresult cuEventElapsedTime(float* ms, CUevent start, CUevent end) {
  if (!ms || !start || !end) return CUDA_ERROR_INVALID_VALUE;
  uint64_t a = reinterpret_cast<MockEvent*>(start)->t_ns;
  uint64_t b = reinterpret_cast<MockEvent*>(end)->t_ns;
  *ms = (float)((double)(b - a) / 1e6);
  return CUDA_SUCCESS;
}

CUresult cuStreamIsCapturing(CUstream, int* status) {
  if (!status) return CUDA_ERROR_INVALID_VALUE;
  *status = CU_STREAM_CAPTURE_STATUS_NONE;
  return CUDA_SUCCESS;
}

CUresult cuStreamIsCapturing_ptsz(CUstream s, int* status) {
  return cuStreamIsCapturing(s, status);
}

// -- code loading -------------------------------------------------------------
static int g_code[256];  // identities of loaded modules

CUresult cuModuleLoadData(CUmodule* m, const void*) {
  count("cuModuleLoadData");
  if (!m) return CUDA_ERROR_INVALID_VALUE;
  if (current_dev() < 0) return CUDA_ERROR_INVALID_CONTEXT;
  std::lock_guard<std::mutex> g(g_mu);
  static int next = 0;
  if (next >= 256) return CUDA_ERROR_OUT_OF_MEMORY;
  *m = reinterpret_cast<CUmodule>(&g_code[next++]);
  return CUDA_SUCCESS;
}

CUresult cuModuleGetFunction(CUfunction* f, CUmodule m, const char*) {
  count("cuModuleGetFunction");
  if (!f || !m) return CUDA_ERROR_INVALID_VALUE;
  *f = reinterpret_cast<CUfunction>(m);  // a handle derived from its module
  return CUDA_SUCCESS;
}

// -- entry-point lookup ---------------------------------------------------------
CUresult cuGetProcAddress_v2(const char* symbol, void** pfn, int version,
                             cuuint64_t flags,
                             CUdriverProcAddressQueryResult* status);

CUresult cuGetProcAddress(const char* symbol, void** pfn, int version,
                          cuuint64_t flags) {
  count("cuGetProcAddress");
  return cuGetProcAddress_v2(symbol, pfn, version, flags, nullptr);
}

struct Entry {
  const char* name;  // the exported, versioned name
  void* fn;
};

// Entry points a lookup may return in place of the exported symbol.
static CUresult internal_cuMemAlloc_v2(CUdeviceptr* dptr, size_t bytes) {
  return cuMemAlloc_v2(dptr, bytes);
}

static CUresult internal_cuLaunchKernel_ptsz(MOCK_LAUNCH_ARGS, void** extra) {
  return cuLaunchKernel_ptsz(f, 1, 1, 1, 1, 1, 1, 0, nullptr, nullptr, extra);
}

#define MOCK_ENTRY(n) {#n, (void*)&n}

CUresult cuGetProcAddress_v2(const char* symbol, void** pfn, int version,
                             cuuint64_t flags,
                             CUdriverProcAddressQueryResult* status) {
  count("cuGetProcAddress_v2");
  static const Entry kEntries[] = {
      MOCK_ENTRY(cuInit), MOCK_ENTRY(cuDeviceGetCount),
      MOCK_ENTRY(cuDeviceGetUuid),
      MOCK_ENTRY(cuDeviceTotalMem_v2), MOCK_ENTRY(cuDevicePrimaryCtxRetain),
      MOCK_ENTRY(cuDevicePrimaryCtxRelease_v2), MOCK_ENTRY(cuCtxCreate_v2),
      MOCK_ENTRY(cuCtxCreate_v3), MOCK_ENTRY(cuCtxCreate_v4),
      MOCK_ENTRY(cuCtxSetCurrent), MOCK_ENTRY(cuCtxGetCurrent),
      MOCK_ENTRY(cuCtxGetDevice), MOCK_ENTRY(cuCtxPushCurrent_v2),
      MOCK_ENTRY(cuCtxPopCurrent_v2), MOCK_ENTRY(cuCtxSynchronize),
      MOCK_ENTRY(cuMemAlloc_v2), MOCK_ENTRY(cuMemAllocPitch_v2),
      MOCK_ENTRY(cuMemAllocManaged), MOCK_ENTRY(cuMemFree_v2),
      MOCK_ENTRY(cuMemAllocAsync), MOCK_ENTRY(cuMemAllocAsync_ptsz),
      MOCK_ENTRY(cuMemAllocFromPoolAsync),
      MOCK_ENTRY(cuMemAllocFromPoolAsync_ptsz), MOCK_ENTRY(cuMemFreeAsync),
      MOCK_ENTRY(cuMemFreeAsync_ptsz), MOCK_ENTRY(cuMemCreate),
      MOCK_ENTRY(cuMemRelease), MOCK_ENTRY(cuMemGetInfo_v2),
      MOCK_ENTRY(cuLaunchKernel), MOCK_ENTRY(cuLaunchKernel_ptsz),
      MOCK_ENTRY(cuLaunchCooperativeKernel),
      MOCK_ENTRY(cuLaunchCooperativeKernel_ptsz),
      MOCK_ENTRY(cuLaunchKernelEx), MOCK_ENTRY(cuLaunchKernelEx_ptsz),
      MOCK_ENTRY(cuGraphLaunch), MOCK_ENTRY(cuGraphLaunch_ptsz),
      MOCK_ENTRY(cuEventCreate), MOCK_ENTRY(cuEventDestroy_v2),
      MOCK_ENTRY(cuEventRecord), MOCK_ENTRY(cuEventRecord_ptsz),
      MOCK_ENTRY(cuEventQuery), MOCK_ENTRY(cuEventSynchronize),
      MOCK_ENTRY(cuEventElapsedTime), MOCK_ENTRY(cuStreamIsCapturing),
      MOCK_ENTRY(cuStreamIsCapturing_ptsz), MOCK_ENTRY(cuModuleLoadData),
      MOCK_ENTRY(cuModuleGetFunction), MOCK_ENTRY(internal_cuMemAlloc_v2),
      MOCK_ENTRY(internal_cuLaunchKernel_ptsz), MOCK_ENTRY(cuGetProcAddress),
      MOCK_ENTRY(cuGetProcAddress_v2),
  };
  // The driver's versioning: a base name and the CUDA version the caller
  // was built for select the versioned entry point.
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
      {"cuCtxPushCurrent", 4000, "cuCtxPushCurrent_v2"},
      {"cuCtxPopCurrent", 4000, "cuCtxPopCurrent_v2"},
      {"cuEventDestroy", 4000, "cuEventDestroy_v2"},
      {"cuDevicePrimaryCtxRelease", 11000, "cuDevicePrimaryCtxRelease_v2"},
      {"cuGetProcAddress", 12000, "cuGetProcAddress_v2"},
  };
  static const char* const kPerThread[] = {
      "cuLaunchKernel", "cuLaunchKernelEx", "cuLaunchCooperativeKernel",
      "cuGraphLaunch", "cuMemAllocAsync", "cuMemAllocFromPoolAsync",
      "cuMemFreeAsync", "cuEventRecord", "cuStreamIsCapturing",
  };
  if (!symbol || !pfn) return CUDA_ERROR_INVALID_VALUE;
  std::string want = symbol;
  for (const auto& v : kVersions) {
    if (want == v.base && version >= v.min_version) {
      want = v.name;
      break;
    }
  }
  if (flags & CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM) {
    for (const char* p : kPerThread)
      if (want == p) {
        want += "_ptsz";
        break;
      }
  }
  if (getenv("MOCK_INTERNAL_ENTRIES")) {
    if (want == "cuMemAlloc_v2") want = "internal_cuMemAlloc_v2";
    if (want == "cuLaunchKernel_ptsz") want = "internal_cuLaunchKernel_ptsz";
  }
  for (const auto& e : kEntries) {
    if (want == e.name) {
      *pfn = e.fn;
      if (status) *status = CU_GET_PROC_ADDRESS_SUCCESS;
      return CUDA_SUCCESS;
    }
  }
  *pfn = nullptr;
  if (status) *status = CU_GET_PROC_ADDRESS_SYMBOL_NOT_FOUND;
  return CUDA_ERROR_NOT_FOUND;
}

// -- NVML -----------------------------------------------------------------------
nvmlReturn_t nvmlInit_v2(void) { return NVML_SUCCESS; }
nvmlReturn_t nvmlInit(void) { return NVML_SUCCESS; }
nvmlReturn_t nvmlShutdown(void) { return NVML_SUCCESS; }

nvmlReturn_t nvmlDeviceGetCount_v2(unsigned int* n) {
  *n = kDevices;
  return NVML_SUCCESS;
}

static int g_nvml_dev[kDevices];  // identities of the NVML handles

static int nvml_index(nvmlDevice_t d) {
  int idx = (int)(reinterpret_cast<int*>(d) - g_nvml_dev);
  return idx >= 0 && idx < kDevices ? idx : -1;
}

nvmlReturn_t nvmlDeviceGetHandleByIndex_v2(unsigned int i, nvmlDevice_t* d) {
  if (i >= (unsigned)kDevices || !d) return NVML_ERROR_INVALID_ARGUMENT;
  *d = reinterpret_cast<nvmlDevice_t>(&g_nvml_dev[i]);
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetHandleByUUID(const char* uuid, nvmlDevice_t* d) {
  for (int i = 0; i < kDevices; ++i)
    if (uuid && uuid_string(i) == uuid)
      return nvmlDeviceGetHandleByIndex_v2((unsigned)i, d);
  return NVML_ERROR_NOT_FOUND;
}

nvmlReturn_t nvmlDeviceGetUUID(nvmlDevice_t d, char* buf, unsigned int len) {
  int i = nvml_index(d);
  if (i < 0 || !buf) return NVML_ERROR_INVALID_ARGUMENT;
  std::string s = uuid_string(i);
  if (len < s.size() + 1) return NVML_ERROR_INSUFFICIENT_SIZE;
  memcpy(buf, s.c_str(), s.size() + 1);
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetIndex(nvmlDevice_t d, unsigned int* index) {
  int i = nvml_index(d);
  if (i < 0 || !index) return NVML_ERROR_INVALID_ARGUMENT;
  *index = (unsigned)i;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetMemoryInfo(nvmlDevice_t d, nvmlMemory_t* m) {
  count("nvmlDeviceGetMemoryInfo");
  int i = nvml_index(d);
  if (i < 0 || !m) return NVML_ERROR_INVALID_ARGUMENT;
  std::lock_guard<std::mutex> g(g_mu);
  m->total = total_bytes();
  m->used = g_used[i];
  m->free = m->total - m->used;
  return NVML_SUCCESS;
}

nvmlReturn_t nvmlDeviceGetMemoryInfo_v2(nvmlDevice_t d, nvmlMemory_v2_t* m) {
  count("nvmlDeviceGetMemoryInfo_v2");
  int i = nvml_index(d);
  if (i < 0 || !m) return NVML_ERROR_INVALID_ARGUMENT;
  std::lock_guard<std::mutex> g(g_mu);
  m->total = total_bytes();
  m->reserved = 0;
  m->used = g_used[i];
  m->free = m->total - m->used;
  return NVML_SUCCESS;
}

}  // extern "C"
