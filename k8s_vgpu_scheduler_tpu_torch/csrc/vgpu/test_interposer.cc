// Test driver for the CUDA driver-API interposer: a C program that drives
// the driver the way the CUDA runtime does -- dlopen("libcuda.so.1"),
// dlsym its cuGetProcAddress_v2, and every other entry point through that
// -- so nothing here names a hook, and whatever is enforced was caught on
// the runtime's own lookup path.  The counterpart of the TPU library's
// test_interposer.cc.  Run by tests/test_torch_interposer.py
// with LD_PRELOAD=<the interposer>, LD_LIBRARY_PATH=<the mock driver's
// directory> and a grant, e.g. for `main`:
//
//   CUDA_DEVICE_MEMORY_SHARED_CACHE=<tmp>/cudevshr.cache
//   CUDA_DEVICE_MEMORY_LIMIT_0=100m        (device 1 uncapped)
//   CUDA_DEVICE_SM_LIMIT=30  CUDA_TASK_PRIORITY=1
//
//   test_interposer main         the reference driver's scenario
//   test_interposer context      contexts, VMM, pitch, managed
//   test_interposer hooks        every hook through dlsym and lookup
//   test_interposer steps        a sequence, with the region's use after
//                                each step (held to the PJRT interposer's)
//   test_interposer pod <MiB>    blocks of <MiB> until refused
//   test_interposer passthrough  outside a managed container
//   test_interposer launch_cost <n>  host ns of a launch of a null kernel
//                                through the hooks and straight to the
//                                driver, in one process (for the card)
//
// Prints PASS/FAIL lines and ends with RESULT PASS or RESULT FAIL <n>;
// exits 0 only if everything passed (2 if the driver cannot be reached).

#include <dlfcn.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <unistd.h>

#include <string>

#include "cuda_types.h"

static int g_failures = 0;

#define CHECK(cond, what)            \
  do {                               \
    if (cond) {                      \
      printf("PASS %s\n", what);     \
    } else {                         \
      printf("FAIL %s\n", what);     \
      ++g_failures;                  \
    }                                \
  } while (0)

static const uint64_t kMiB = 1ull << 20;
static const int kVersion = 12080;  // the CUDA version a runtime asks for

typedef CUresult (*gpa_t)(const char*, void**, int, cuuint64_t,
                          CUdriverProcAddressQueryResult*);
static gpa_t g_gpa = nullptr;
static void* g_interposer_base = nullptr;

// What the runtime does for every entry point.
static void* entry(const char* name, int version = kVersion,
                   cuuint64_t flags = 0) {
  void* p = nullptr;
  CUdriverProcAddressQueryResult st = 0;
  if (!g_gpa || g_gpa(name, &p, version, flags, &st) != CUDA_SUCCESS)
    return nullptr;
  return p;
}

// Whether `p` lies in the interposer (the object exporting
// vgpu_interposer_active), not in the driver.
static bool hooked(void* p) {
  Dl_info info;
  return p && g_interposer_base && dladdr(p, &info) &&
         info.dli_fbase == g_interposer_base;
}

#define ENTRY(type, name, ...) ((type)entry(name, ##__VA_ARGS__))

typedef CUresult (*init_t)(unsigned);
typedef CUresult (*count_t)(int*);
typedef CUresult (*retain_t)(CUcontext*, CUdevice);
typedef CUresult (*setctx_t)(CUcontext);
typedef CUresult (*alloc_t)(CUdeviceptr*, size_t);
typedef CUresult (*free_t)(CUdeviceptr);
typedef CUresult (*async_t)(CUdeviceptr*, size_t, CUstream);
typedef CUresult (*info_t)(size_t*, size_t*);
typedef CUresult (*total_t)(size_t*, CUdevice);
typedef CUresult (*launch_t)(CUfunction, unsigned, unsigned, unsigned,
                             unsigned, unsigned, unsigned, unsigned, CUstream,
                             void**, void**);
typedef CUresult (*create_t)(CUmemGenericAllocationHandle*, size_t,
                             const CUmemAllocationProp*, unsigned long long);
typedef CUresult (*release_t)(CUmemGenericAllocationHandle);
typedef CUresult (*pitch_t)(CUdeviceptr*, size_t*, size_t, size_t, unsigned);
typedef CUresult (*managed_t)(CUdeviceptr*, size_t, unsigned);
typedef CUresult (*ctxcreate_t)(CUcontext*, unsigned, CUdevice);
typedef CUresult (*modload_t)(CUmodule*, const void*);
typedef CUresult (*getfn_t)(CUfunction*, CUmodule, const char*);
typedef nvmlReturn_t (*nvml_handle_t)(unsigned, nvmlDevice_t*);
typedef nvmlReturn_t (*nvml_mem_t)(nvmlDevice_t, nvmlMemory_t*);
typedef nvmlReturn_t (*nvml_mem2_t)(nvmlDevice_t, nvmlMemory_v2_t*);

// The interposer's own surface, looked up in the process, and the mock
// driver's call counts, looked up in the driver.
struct Control {
  void (*rate_test_mode)(int);
  uint64_t (*rate_test_now)(void);
  void* (*region)(void);
  void (*set_switch)(void*, int);
  uint64_t (*get_used)(int);
  uint64_t (*get_limit)(int);
  int (*active)(void);
  int (*stats)(int, uint64_t*, int);
  const char* (*hooks)(void);
  uint64_t (*mock_calls)(const char*);
};

static Control control(void* cuda) {
  Control c;
  c.rate_test_mode = (void (*)(int))dlsym(RTLD_DEFAULT, "vgpu_rate_test_mode");
  c.rate_test_now = (uint64_t(*)(void))dlsym(RTLD_DEFAULT, "vgpu_rate_test_now");
  c.region = (void* (*)(void))dlsym(RTLD_DEFAULT, "vgpu_region");
  c.set_switch = (void (*)(void*, int))dlsym(RTLD_DEFAULT, "vgpu_r_set_switch");
  c.get_used = (uint64_t(*)(int))dlsym(RTLD_DEFAULT, "vgpu_get_used");
  c.get_limit = (uint64_t(*)(int))dlsym(RTLD_DEFAULT, "vgpu_get_limit");
  c.active = (int (*)(void))dlsym(RTLD_DEFAULT, "vgpu_interposer_active");
  c.stats = (int (*)(int, uint64_t*, int))dlsym(RTLD_DEFAULT,
                                               "vgpu_interposer_stats");
  c.hooks = (const char* (*)(void))dlsym(RTLD_DEFAULT,
                                         "vgpu_interposer_hooks");
  c.mock_calls = (uint64_t(*)(const char*))dlsym(cuda, "mock_cuda_calls");
  return c;
}

static uint64_t counter(const Control& c, int dev, int field) {
  uint64_t v[16] = {0};
  c.stats(dev, v, 16);
  return v[field];
}
enum { S_LAUNCHES, S_GATED, S_CHARGED_US, S_SAMPLES, S_SAMPLED_US, S_CONTEXT,
       S_ALLOC, S_REFUSALS, S_CAPTURE };

static CUcontext g_ctx[2];

static void use_device(int dev) {
  ENTRY(setctx_t, "cuCtxSetCurrent")(g_ctx[dev]);
}

static int bring_up() {
  if (ENTRY(init_t, "cuInit")(0) != CUDA_SUCCESS) return 1;
  retain_t retain = ENTRY(retain_t, "cuDevicePrimaryCtxRetain");
  for (int d = 0; d < 2; ++d)
    if (retain(&g_ctx[d], d) != CUDA_SUCCESS) return 1;
  use_device(0);
  return 0;
}

static CUresult alloc_mib(uint64_t mib, CUdeviceptr* p) {
  return ENTRY(alloc_t, "cuMemAlloc")(p, mib * kMiB);
}

static void launches(int n, const char* name = "cuLaunchKernel",
                     cuuint64_t flags = 0, void* fn = (void*)0x1) {
  launch_t launch = ENTRY(launch_t, name, kVersion, flags);
  for (int i = 0; i < n; ++i)
    launch((CUfunction)fn, 1, 1, 1, 32, 1, 1, 0, nullptr, nullptr, nullptr);
}

static uint64_t used_by_memgetinfo(uint64_t* total) {
  size_t free_b = 0, total_b = 0;
  ENTRY(info_t, "cuMemGetInfo")(&free_b, &total_b);
  *total = total_b;
  return total_b - free_b;
}

// -- main: the TPU library's test_interposer.cc scenario ---------------------
static void run_main(const Control& c) {
  CHECK(c.rate_test_mode && c.rate_test_now && c.region && c.set_switch &&
            c.active && c.stats,
        "interposer exports the vgpu control surface");
  CHECK(c.active && c.active() == 1, "interposer attached to the region");
  bool up = bring_up() == 0;
  CHECK(up, "cuInit and primary contexts");
  if (!up) return;
  int n = 0;
  CHECK(ENTRY(count_t, "cuDeviceGetCount")(&n) == CUDA_SUCCESS && n == 2,
        "device count passthrough");

  // ---- memory cap: 50 MiB fits the 100 MiB grant, +60 MiB is refused ----
  CUdeviceptr b50 = 0, b60 = 0, b60b = 0;
  CHECK(alloc_mib(50, &b50) == CUDA_SUCCESS && b50, "50 MiB alloc inside grant");
  CUresult rc = alloc_mib(60, &b60);
  CHECK(rc == CUDA_ERROR_OUT_OF_MEMORY,
        "60 MiB over-grant alloc refused with CUDA_ERROR_OUT_OF_MEMORY");
  CHECK(c.mock_calls("cuMemAlloc_v2") == 1,
        "the refused alloc never reached the driver");

  // ---- virtualized memory info -------------------------------------------
  uint64_t total = 0;
  uint64_t used = used_by_memgetinfo(&total);
  CHECK(total == 100 * kMiB, "cuMemGetInfo total reports the grant");
  CHECK(used == 50 * kMiB, "cuMemGetInfo reports the accounted usage");
  void* nvml = dlopen("libnvidia-ml.so.1", RTLD_NOW);
  nvml_handle_t by_index =
      nvml ? (nvml_handle_t)dlsym(nvml, "nvmlDeviceGetHandleByIndex_v2")
           : nullptr;
  nvml_mem_t mem = nvml ? (nvml_mem_t)dlsym(nvml, "nvmlDeviceGetMemoryInfo")
                        : nullptr;
  nvmlDevice_t h0 = nullptr;
  nvmlMemory_t m = {0, 0, 0};
  CHECK(by_index && mem && by_index(0, &h0) == NVML_SUCCESS &&
            mem(h0, &m) == NVML_SUCCESS && m.total == 100 * kMiB &&
            m.used == 50 * kMiB && m.free == 50 * kMiB,
        "nvmlDeviceGetMemoryInfo reports the grant and the usage");

  // ---- free releases the charge ------------------------------------------
  CHECK(ENTRY(free_t, "cuMemFree")(b50) == CUDA_SUCCESS, "cuMemFree");
  CHECK(alloc_mib(60, &b60b) == CUDA_SUCCESS, "60 MiB fits after free");

  // ---- a second device has its own slot ------------------------------------
  use_device(1);
  CUdeviceptr d1 = 0;
  CHECK(alloc_mib(60, &d1) == CUDA_SUCCESS, "60 MiB on uncapped device 1");
  use_device(0);
  CUdeviceptr again = 0;
  CHECK(alloc_mib(60, &again) == CUDA_ERROR_OUT_OF_MEMORY,
        "over-grant alloc on device 0 refused");

  // ---- stream-ordered allocations are charged -------------------------------
  CUdeviceptr a1 = 0;
  CHECK(ENTRY(async_t, "cuMemAllocAsync")(&a1, kMiB, nullptr) == CUDA_SUCCESS,
        "cuMemAllocAsync passthrough");
  CHECK(c.get_used(0) == 61 * kMiB, "stream-ordered alloc charged (60 + 1 MiB)");

  // ---- launches pass through, on both stream flavours ------------------------
  launches(1);
  CHECK(c.mock_calls("cuLaunchKernel") == 1, "cuLaunchKernel passthrough");
  launches(1, "cuLaunchKernel", CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM);
  CHECK(c.mock_calls("cuLaunchKernel_ptsz") == 1,
        "per-thread-stream lookup reaches cuLaunchKernel_ptsz");

  // ---- duty-cycle throttling of the launches ---------------------------------
  // Low priority + the monitor's switch on: every launch passes the
  // limiter.  The test clock advances instead of sleeping.
  c.set_switch(c.region(), 1);
  c.rate_test_mode(1);
  setenv("MOCK_EXEC_US", "2000", 1);  // 2 ms device time a launch
  uint64_t charged0 = counter(c, 0, S_CHARGED_US);
  const int kLaunches = 400;
  launches(kLaunches, "cuLaunchKernel", 0, (void*)0x2);
  uint64_t waited_us = c.rate_test_now() / 1000;
  uint64_t charged = counter(c, 0, S_CHARGED_US) - charged0;
  // 400 x 2 ms = 800 ms of device time at a 30% grant needs
  // (800 - 200 burst) / 0.3 = 2.0 s of throttle waiting.
  CHECK(waited_us > 1200000, "launches throttled to the duty cycle");
  CHECK(waited_us < 10000000, "throttle wait bounded");
  // The first two launches are charged before their timing is read.
  CHECK(charged >= (kLaunches - 2) * 2000ull && charged <= kLaunches * 2000ull,
        "each launch charged its event-timed device time");
  double want = (double)(charged - 200000) / 0.3;
  CHECK(waited_us > want * 0.99 && waited_us < want * 1.01 + 2000,
        "waits are the charge over the grant's rate");
  c.rate_test_mode(0);
  setenv("MOCK_EXEC_US", "0", 1);

  // ---- a sharer's time slices do not raise an estimate -----------------------
  // With the switch on, the kernel's pair spans the other pod's slices too
  // (here: the device time trebles): re-timed launches leave the shape's
  // estimate where it was, and only a shorter one would lower it; with the
  // switch off again it follows them.
  c.set_switch(c.region(), 0);
  c.rate_test_mode(1);
  setenv("MOCK_EXEC_US", "100", 1);
  launches(4, "cuLaunchKernel", 0, (void*)0x3);
  c.set_switch(c.region(), 1);
  setenv("MOCK_EXEC_US", "300", 1);
  uint64_t base_us = counter(c, 0, S_CHARGED_US);
  uint64_t sampled0 = counter(c, 0, S_SAMPLES);
  launches(130, "cuLaunchKernel", 0, (void*)0x3);
  CHECK(counter(c, 0, S_CHARGED_US) - base_us == 130 * 100ull &&
            counter(c, 0, S_SAMPLES) > sampled0,
        "launches timed beside a sharer do not raise the estimate");
  setenv("MOCK_EXEC_US", "50", 1);
  base_us = counter(c, 0, S_CHARGED_US);
  launches(130, "cuLaunchKernel", 0, (void*)0x3);
  CHECK(counter(c, 0, S_CHARGED_US) - base_us < 130 * 100ull,
        "a shorter launch beside a sharer lowers the estimate");
  setenv("MOCK_EXEC_US", "300", 1);
  c.set_switch(c.region(), 0);
  base_us = counter(c, 0, S_CHARGED_US);
  launches(130, "cuLaunchKernel", 0, (void*)0x3);
  CHECK(counter(c, 0, S_CHARGED_US) - base_us > 130 * 100ull,
        "alone again, the estimate follows the launches' device time");
  c.rate_test_mode(0);
  setenv("MOCK_EXEC_US", "0", 1);

  // ---- versioned lookups: the driver's mapping decides ----------------------
  CHECK(hooked(entry("cuCtxCreate", 3020)) && hooked(entry("cuCtxCreate", 11040)) &&
            hooked(entry("cuCtxCreate", 12080)) &&
            entry("cuCtxCreate", 3020) != entry("cuCtxCreate", 11040) &&
            entry("cuCtxCreate", 11040) != entry("cuCtxCreate", 12080),
        "cuCtxCreate at 3020, 11040 and 12080 reach _v2, _v3 and _v4 hooks");
  CHECK(!hooked(entry("cuCtxGetDevice")) && entry("cuCtxGetDevice"),
        "an unhooked entry point is the driver's own");
}

// -- context: what lives outside the allocations ------------------------------
// Each context is charged VTPU_CONTEXT_MIB, whatever the driver takes from
// the device's free memory for it (MOCK_CTX_BYTES, set to differ).
static void run_context(const Control& c) {
  const uint64_t ctx = strtoull(getenv("VTPU_CONTEXT_MIB"), nullptr, 10) * kMiB;
  CHECK(bring_up() == 0, "cuInit and primary contexts");
  CHECK(c.get_used(0) == ctx && c.get_used(1) == ctx,
        "each primary context charged its fixed footprint when it is made");
  CUcontext again = nullptr;
  ENTRY(retain_t, "cuDevicePrimaryCtxRetain")(&again, 0);
  CHECK(c.get_used(0) == ctx, "a second retain charges nothing");
  CHECK(counter(c, 0, S_CONTEXT) == ctx, "context bytes counted");
  CUcontext own = nullptr;
  ctxcreate_t ctxcreate = ENTRY(ctxcreate_t, "cuCtxCreate", 3020);
  CHECK(ctxcreate(&own, 0, 1) == CUDA_SUCCESS && c.get_used(1) == 2 * ctx,
        "a created context is charged too");
  CUdeviceptr fill = 0;
  use_device(1);
  const uint64_t room = c.get_limit(1) - c.get_used(1);
  CHECK(alloc_mib(room / kMiB - ctx / kMiB + 1, &fill) == CUDA_SUCCESS &&
            ctxcreate(&own, 0, 1) == CUDA_ERROR_OUT_OF_MEMORY &&
            c.mock_calls("cuCtxCreate_v2") == 1 &&
            c.get_used(1) == 2 * ctx + (room / kMiB - ctx / kMiB + 1) * kMiB,
        "a context the grant cannot hold is refused before the driver");
  ENTRY(free_t, "cuMemFree")(fill);
  use_device(0);
  launches(3, "cuLaunchKernel", 0, (void*)0x10);
  CHECK(c.get_used(0) == ctx, "launches charge nothing");

  const uint64_t base = c.get_used(0);
  const uint64_t limit = c.get_limit(0);
  CUmemAllocationProp prop;
  memset(&prop, 0, sizeof(prop));
  prop.type = 1;
  prop.location_type = CU_MEM_LOCATION_TYPE_DEVICE;
  prop.location_id = 0;
  CUmemGenericAllocationHandle h = 0, over = 0, host = 0;
  create_t create = ENTRY(create_t, "cuMemCreate");
  release_t release = ENTRY(release_t, "cuMemRelease");
  CHECK(create(&h, 20 * kMiB, &prop, 0) == CUDA_SUCCESS &&
            c.get_used(0) == base + 20 * kMiB,
        "cuMemCreate on the device charged");
  CHECK(create(&over, limit, &prop, 0) == CUDA_ERROR_OUT_OF_MEMORY,
        "cuMemCreate past the grant refused");
  CHECK(release(h) == CUDA_SUCCESS && c.get_used(0) == base,
        "cuMemRelease releases the charge");
  prop.location_type = 2;  // host
  CHECK(create(&host, 20 * kMiB, &prop, 0) == CUDA_SUCCESS &&
            c.get_used(0) == base && release(host) == CUDA_SUCCESS,
        "host-located cuMemCreate not charged");

  CUdeviceptr p = 0;
  size_t pitch = 0;
  CHECK(ENTRY(pitch_t, "cuMemAllocPitch")(&p, &pitch, 1000, 10, 4) ==
                CUDA_SUCCESS &&
            c.get_used(0) == base + pitch * 10,
        "cuMemAllocPitch charged its pitch times height");
  ENTRY(free_t, "cuMemFree")(p);
  CHECK(ENTRY(managed_t, "cuMemAllocManaged")(&p, 4 * kMiB, 1) ==
                CUDA_SUCCESS &&
            c.get_used(0) == base + 4 * kMiB,
        "cuMemAllocManaged charged");
  ENTRY(free_t, "cuMemFree")(p);
  CHECK(c.get_used(0) == base && counter(c, 0, S_ALLOC) == 0,
        "frees release every allocation's charge");

  size_t total = 0;
  CHECK(ENTRY(total_t, "cuDeviceTotalMem")(&total, 0) == CUDA_SUCCESS &&
            total == limit,
        "cuDeviceTotalMem reports the grant");
  void* nvml = dlopen("libnvidia-ml.so.1", RTLD_NOW);
  if (!nvml) {  // the charges above needed none
    printf("NVML absent\n");
    return;
  }
  nvml_handle_t by_index = (nvml_handle_t)dlsym(nvml, "nvmlDeviceGetHandleByIndex_v2");
  nvml_mem2_t mem2 = (nvml_mem2_t)dlsym(nvml, "nvmlDeviceGetMemoryInfo_v2");
  nvmlDevice_t h0 = nullptr;
  nvmlMemory_v2_t m2;
  memset(&m2, 0, sizeof(m2));
  m2.version = (unsigned)sizeof(m2) | (2u << 24);
  CHECK(by_index(0, &h0) == NVML_SUCCESS && mem2(h0, &m2) == NVML_SUCCESS &&
            m2.total == limit && m2.used == base && m2.free == limit - base,
        "nvmlDeviceGetMemoryInfo_v2 reports the grant and the usage");
}

// -- hooks: every hook through both lookup paths -------------------------------
struct Expected {
  const char* name;   // the hooked, versioned entry point
  const char* base;   // what cuGetProcAddress is asked for
  int version;
  cuuint64_t flags;
};

static void run_hooks(const Control& c) {
  const cuuint64_t ptds = CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM;
  static const Expected kExpected[] = {
      {"cuInit", "cuInit", kVersion, 0},
      {"cuGetProcAddress", "cuGetProcAddress", 11030, 0},
      {"cuGetProcAddress_v2", "cuGetProcAddress", kVersion, 0},
      {"cuMemAlloc_v2", "cuMemAlloc", kVersion, 0},
      {"cuMemAllocPitch_v2", "cuMemAllocPitch", kVersion, 0},
      {"cuMemAllocManaged", "cuMemAllocManaged", kVersion, 0},
      {"cuMemFree_v2", "cuMemFree", kVersion, 0},
      {"cuMemAllocAsync", "cuMemAllocAsync", kVersion, 0},
      {"cuMemAllocAsync_ptsz", "cuMemAllocAsync", kVersion, ptds},
      {"cuMemAllocFromPoolAsync", "cuMemAllocFromPoolAsync", kVersion, 0},
      {"cuMemAllocFromPoolAsync_ptsz", "cuMemAllocFromPoolAsync", kVersion,
       ptds},
      {"cuMemFreeAsync", "cuMemFreeAsync", kVersion, 0},
      {"cuMemFreeAsync_ptsz", "cuMemFreeAsync", kVersion, ptds},
      {"cuMemCreate", "cuMemCreate", kVersion, 0},
      {"cuMemRelease", "cuMemRelease", kVersion, 0},
      {"cuMemGetInfo_v2", "cuMemGetInfo", kVersion, 0},
      {"cuDeviceTotalMem_v2", "cuDeviceTotalMem", kVersion, 0},
      {"cuDevicePrimaryCtxRetain", "cuDevicePrimaryCtxRetain", kVersion, 0},
      {"cuCtxCreate_v2", "cuCtxCreate", 3020, 0},
      {"cuCtxCreate_v3", "cuCtxCreate", 11040, 0},
      {"cuCtxCreate_v4", "cuCtxCreate", kVersion, 0},
      {"cuLaunchKernel", "cuLaunchKernel", kVersion, 0},
      {"cuLaunchKernel_ptsz", "cuLaunchKernel", kVersion, ptds},
      {"cuLaunchKernelEx", "cuLaunchKernelEx", kVersion, 0},
      {"cuLaunchKernelEx_ptsz", "cuLaunchKernelEx", kVersion, ptds},
      {"cuLaunchCooperativeKernel", "cuLaunchCooperativeKernel", kVersion, 0},
      {"cuLaunchCooperativeKernel_ptsz", "cuLaunchCooperativeKernel",
       kVersion, ptds},
      {"cuGraphLaunch", "cuGraphLaunch", kVersion, 0},
      {"cuGraphLaunch_ptsz", "cuGraphLaunch", kVersion, ptds},
  };
  printf("HOOKS %s\n", c.hooks ? c.hooks() : "");
  void* cuda = dlopen("libcuda.so.1", RTLD_NOW);
  for (const Expected& e : kExpected) {
    printf("HOOK dlsym %s %s\n", e.name,
           hooked(dlsym(cuda, e.name)) ? "ok" : "missing");
    printf("HOOK lookup %s %s\n", e.name,
           hooked(entry(e.base, e.version, e.flags)) ? "ok" : "missing");
  }
  void* nvml = dlopen("libnvidia-ml.so.1", RTLD_NOW);
  for (const char* name :
       {"nvmlDeviceGetMemoryInfo", "nvmlDeviceGetMemoryInfo_v2"})
    printf("HOOK dlsym %s %s\n", name,
           hooked(dlsym(nvml, name)) ? "ok" : "missing");
  CHECK(!hooked(dlsym(cuda, "cuCtxGetDevice")) && dlsym(cuda, "cuCtxGetDevice"),
        "dlsym of an unhooked name is the driver's own");
  CHECK(dlsym(cuda, "cuNoSuchEntryPoint") == nullptr,
        "dlsym of a missing name stays missing");
}

// -- steps: a sequence, the region's use after each step ----------------------
static void step(const Control& c, const char* name, CUresult rc) {
  printf("STEP %s refused=%d used0=%llu used1=%llu\n", name,
         rc == CUDA_ERROR_OUT_OF_MEMORY ? 1 : 0,
         (unsigned long long)c.get_used(0), (unsigned long long)c.get_used(1));
}

static void run_steps(const Control& c) {
  CHECK(bring_up() == 0, "cuInit and primary contexts");
  printf("LIMIT %llu %llu\n", (unsigned long long)c.get_limit(0),
         (unsigned long long)c.get_limit(1));
  CUdeviceptr b50 = 0, b60 = 0, b60b = 0, d1 = 0, again = 0;
  step(c, "alloc50", alloc_mib(50, &b50));
  step(c, "alloc60", alloc_mib(60, &b60));
  step(c, "free50", ENTRY(free_t, "cuMemFree")(b50));
  step(c, "alloc60b", alloc_mib(60, &b60b));
  use_device(1);
  step(c, "dev1_60", alloc_mib(60, &d1));
  use_device(0);
  step(c, "dev0_60", alloc_mib(60, &again));
  step(c, "free60b", ENTRY(free_t, "cuMemFree")(b60b));
  launches(3);
  step(c, "launch3", CUDA_SUCCESS);
}

// -- pod: one process of a pod, taking blocks until refused --------------------
static void run_pod(const Control& c, uint64_t mib) {
  CHECK(bring_up() == 0, "cuInit and primary contexts");
  const char* ready = getenv("POD_READY");
  const char* go = getenv("POD_GO");
  if (ready) fclose(fopen(ready, "w"));
  for (int i = 0; go && access(go, F_OK) != 0 && i < 300000; ++i) usleep(100);
  int blocks = 0;
  CUdeviceptr p = 0;
  while (blocks < 100000 && alloc_mib(mib, &p) == CUDA_SUCCESS) {
    ++blocks;
    usleep(1000);  // leave the other process room to take its blocks
  }
  const uint64_t used = c.get_used(0);  // before the parent reads our line
  CHECK(used + mib * kMiB > c.get_limit(0),
        "took blocks until the pod's grant refused one");
  printf("BLOCKS %d USED %llu\n", blocks, (unsigned long long)used);
  const char* done = getenv("POD_DONE");  // hold the blocks until both ended
  for (int i = 0; done && access(done, F_OK) != 0 && i < 30000; ++i)
    usleep(1000);
}

// -- passthrough: no region, nothing enforced ----------------------------------
static void run_passthrough(const Control& c) {
  CHECK(c.active && c.active() == 0, "interposer loaded but not enforcing");
  CHECK(bring_up() == 0, "cuInit and primary contexts");
  CUdeviceptr big = 0;
  CHECK(alloc_mib(4096, &big) == CUDA_SUCCESS, "an uncapped 4 GiB alloc");
  uint64_t total = 0;
  used_by_memgetinfo(&total);
  size_t dev_total = 0;
  ENTRY(total_t, "cuDeviceTotalMem")(&dev_total, 0);
  CHECK(total == dev_total && total > 4096 * kMiB,
        "cuMemGetInfo reports the physical total");
  c.rate_test_mode(1);
  setenv("MOCK_EXEC_US", "100", 1);
  launches(50);
  CHECK(c.rate_test_now() <= 1, "launches never wait");
  CHECK(c.mock_calls("cuLaunchKernel") == 50, "every launch reached the driver");
  CHECK(counter(c, 0, S_LAUNCHES) == 0, "nothing counted");
}


// -- launch_cost: the hooks' host time a launch, against the driver's own ----
static double now_s() {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return (double)t.tv_sec + (double)t.tv_nsec * 1e-9;
}

static void run_launch_cost(void* cuda, int n) {
  static const char kPtx[] =
      ".version 7.0\n.target sm_50\n.address_size 64\n"
      ".visible .entry vgpu_null() { ret; }\n";
  CUcontext ctx = nullptr;
  CUmodule mod = nullptr;
  CUfunction fn = nullptr;
  bool up = ENTRY(init_t, "cuInit")(0) == CUDA_SUCCESS &&
            ENTRY(retain_t, "cuDevicePrimaryCtxRetain")(&ctx, 0) ==
                CUDA_SUCCESS &&
            ENTRY(setctx_t, "cuCtxSetCurrent")(ctx) == CUDA_SUCCESS &&
            ENTRY(modload_t, "cuModuleLoadData")(&mod, kPtx) ==
                CUDA_SUCCESS &&
            ENTRY(getfn_t, "cuModuleGetFunction")(&fn, mod, "vgpu_null") ==
                CUDA_SUCCESS;
  CHECK(up, "a null kernel loaded");
  if (!up) return;
  // The driver's own entry point, past the interposer's dlsym.
  typedef void* (*dlsym_t)(void*, const char*);
  dlsym_t real_dlsym = (dlsym_t)dlvsym(RTLD_NEXT, "dlsym", "GLIBC_2.34");
  if (!real_dlsym) real_dlsym = (dlsym_t)dlvsym(RTLD_NEXT, "dlsym", "GLIBC_2.2.5");
  launch_t direct = real_dlsym ? (launch_t)real_dlsym(cuda, "cuLaunchKernel")
                               : nullptr;
  launch_t hooked = ENTRY(launch_t, "cuLaunchKernel");
  typedef CUresult (*sync_t)(void);
  sync_t sync = ENTRY(sync_t, "cuCtxSynchronize");
  CHECK(direct && hooked && sync && hooked(fn, 1, 1, 1, 1, 1, 1, 0, nullptr,
                                           nullptr, nullptr) == CUDA_SUCCESS,
        "the null kernel launches");
  if (!direct || !hooked || !sync) return;
  double best[2] = {INFINITY, INFINITY};
  for (int round = 0; round < 5; ++round) {
    launch_t paths[2] = {hooked, direct};
    for (int k = 0; k < 2; ++k) {
      sync();
      double t0 = now_s();
      for (int i = 0; i < n; ++i)
        paths[k](fn, 1, 1, 1, 1, 1, 1, 0, nullptr, nullptr, nullptr);
      double t = (now_s() - t0) / n * 1e9;
      sync();
      if (t < best[k]) best[k] = t;
    }
  }
  printf("LAUNCH_NS hooked %.1f direct %.1f\n", best[0], best[1]);
}

int main(int argc, char** argv) {
  setvbuf(stdout, nullptr, _IOLBF, 0);  // a pod's parent reads as we go
  const char* mode = argc > 1 ? argv[1] : "main";
  void* cuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
  if (!cuda) {
    fprintf(stderr, "dlopen libcuda.so.1: %s\n", dlerror());
    return 2;
  }
  g_gpa = (gpa_t)dlsym(cuda, "cuGetProcAddress_v2");
  Dl_info info;
  void* active = dlsym(RTLD_DEFAULT, "vgpu_interposer_active");
  if (active && dladdr(active, &info)) g_interposer_base = info.dli_fbase;
  CHECK(hooked((void*)g_gpa),
        "dlsym(libcuda, cuGetProcAddress_v2) returns the interposer's hook");
  if (!g_gpa) return 2;
  Control c = control(cuda);
  if (!strcmp(mode, "main"))
    run_main(c);
  else if (!strcmp(mode, "context"))
    run_context(c);
  else if (!strcmp(mode, "hooks"))
    run_hooks(c);
  else if (!strcmp(mode, "steps"))
    run_steps(c);
  else if (!strcmp(mode, "pod"))
    run_pod(c, argc > 2 ? strtoull(argv[2], nullptr, 10) : 10);
  else if (!strcmp(mode, "passthrough"))
    run_passthrough(c);
  else if (!strcmp(mode, "launch_cost"))
    run_launch_cost(cuda, argc > 2 ? atoi(argv[2]) : 20000);
  else {
    fprintf(stderr, "unknown mode %s\n", mode);
    return 2;
  }
  printf(g_failures ? "RESULT FAIL %d\n" : "RESULT PASS\n", g_failures);
  return g_failures ? 1 : 0;
}
