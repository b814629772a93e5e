/* A guard-page allocator for PyTorch (torch.cuda.memory.
 * CUDAPluggableAllocator), with a plain C interface and no PyTorch headers.
 *
 * It holds every kernel of the port to "no global-memory access outside
 * the buffers its wrapper hands it" on a card where compute-sanitizer does
 * not run. Every allocation gets an address reservation of its own from
 * CUDA's virtual memory management API (cuMem*) and maps only the granules
 * the buffer needs; the granule beside the buffer stays reserved and
 * unmapped, so a load or store there kills the context with
 * cudaErrorIllegalAddress. Two placements (guard.py holds the same
 * arithmetic in Python, guard_placement below exports this one):
 *
 *   end:   the size rounded up to 16 bytes ends at the last mapped byte,
 *          so an access past the buffer (beyond < 16 bytes of slack)
 *          faults in the unmapped granule after it;
 *   front: the buffer starts at the first mapped byte and the granule
 *          before it is unmapped, so an access before the buffer faults;
 *   size 0: a unique address in the middle of a granule that is wholly
 *          unmapped.
 *
 * Every mapping is filled with a poison byte at allocation, so a kernel
 * whose output depends on scratch that nothing wrote differs between two
 * runs with two poison bytes (the stand-in for initcheck).
 *
 * Each allocation maps at least one granule (2 MiB on an H100), so the
 * allocator counts its live mappings and their bytes, and their peaks.
 * Freeing synchronises the context first: a kernel queued on any stream
 * may still use the memory. guard_touch is the positive control: a
 * one-thread kernel that reads one byte at a given offset from a pointer.
 *
 * Build: nvcc -shared -Xcompiler -fPIC guard_alloc.cu -lcuda (guard.py).
 */
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <mutex>
#include <unordered_map>

namespace {

constexpr int64_t kAlign = 16;  // an end buffer's size rounds up to this

/* Where a buffer of `size` bytes lies in its reservation (all in bytes):
 * the reservation's size, the offset and size of its mapping, and the
 * buffer's offset. Mode 0 is end, 1 is front. */
struct Placement {
  int64_t reserve, map_offset, mapped, offset;
};

Placement place(int64_t size, int mode, int64_t gran) {
  if (size <= 0) return {gran, 0, 0, gran / 2};
  const int64_t b = (size + kAlign - 1) / kAlign * kAlign;
  const int64_t mapped = (b + gran - 1) / gran * gran;
  if (mode == 0) return {mapped + gran, 0, mapped, mapped - b};
  return {gran + mapped, gran, mapped, gran};
}

struct Record {
  CUdeviceptr base;
  Placement p;
  CUmemGenericAllocationHandle handle;
};

std::mutex mu;
std::unordered_map<uintptr_t, Record> live;
int g_mode = 0;
unsigned char g_fill = 0xA5;
long long n_live = 0, bytes_live = 0, peak_live = 0, peak_bytes = 0;
long long n_allocs = 0, n_free_errors = 0;

CUmemAllocationProp prop_of(int device) {
  CUmemAllocationProp prop = {};
  prop.type = CU_MEM_ALLOCATION_TYPE_PINNED;
  prop.location.type = CU_MEM_LOCATION_TYPE_DEVICE;
  prop.location.id = device;
  return prop;
}

/* An allocation that cannot be made is a broken run, not an out-of-memory
 * to recover from: say which call failed and stop the process. */
void must(CUresult rc, const char *what) {
  if (rc == CUDA_SUCCESS) return;
  const char *name = nullptr;
  cuGetErrorName(rc, &name);
  fprintf(stderr, "[guard] %s failed: CUresult %d (%s)\n", what, (int)rc,
          name ? name : "?");
  fflush(stderr);
  abort();
}

__global__ void touch_kernel(const volatile unsigned char *p,
                             unsigned char *out) {
  *out = *p;
}

}  // namespace

extern "C" {

/* The placement of a buffer of `size` bytes: out[0..3] = reservation,
 * mapping offset, mapped bytes, buffer offset. */
void guard_placement(long long size, int mode, long long gran,
                     long long *out) {
  const Placement p = place(size, mode, gran);
  out[0] = p.reserve;
  out[1] = p.map_offset;
  out[2] = p.mapped;
  out[3] = p.offset;
}

/* CU_DEVICE_ATTRIBUTE_VIRTUAL_MEMORY_MANAGEMENT_SUPPORTED of `device` and
 * its minimum allocation granularity; returns a CUresult. */
int guard_device(int device, int *vmm, long long *granularity) {
  CUresult rc = cuInit(0);
  CUdevice dev;
  if (rc == CUDA_SUCCESS) rc = cuDeviceGet(&dev, device);
  if (rc == CUDA_SUCCESS)
    rc = cuDeviceGetAttribute(
        vmm, CU_DEVICE_ATTRIBUTE_VIRTUAL_MEMORY_MANAGEMENT_SUPPORTED, dev);
  if (rc != CUDA_SUCCESS || !*vmm) return (int)rc;
  const CUmemAllocationProp prop = prop_of(device);
  size_t g = 0;
  rc = cuMemGetAllocationGranularity(&g, &prop,
                                     CU_MEM_ALLOC_GRANULARITY_MINIMUM);
  *granularity = (long long)g;
  return (int)rc;
}

/* The placement of the allocations that follow (0 end, 1 front) and the
 * poison byte that fills them. */
int guard_configure(int mode, int fill) {
  if ((mode != 0 && mode != 1) || fill < 0 || fill > 255) return 1;
  std::lock_guard<std::mutex> lock(mu);
  g_mode = mode;
  g_fill = (unsigned char)fill;
  return 0;
}

/* out[0..5] = live mappings, their bytes, the peaks of both, allocations
 * made, frees that found a broken context. */
void guard_stats(long long *out) {
  std::lock_guard<std::mutex> lock(mu);
  out[0] = n_live;
  out[1] = bytes_live;
  out[2] = peak_live;
  out[3] = peak_bytes;
  out[4] = n_allocs;
  out[5] = n_free_errors;
}

void *guard_alloc(ssize_t size, int device, cudaStream_t stream) {
  std::lock_guard<std::mutex> lock(mu);
  if (cudaSetDevice(device) != cudaSuccess) must(CUDA_ERROR_INVALID_DEVICE,
                                                 "cudaSetDevice");
  const CUmemAllocationProp prop = prop_of(device);
  size_t gran = 0;
  must(cuMemGetAllocationGranularity(&gran, &prop,
                                     CU_MEM_ALLOC_GRANULARITY_MINIMUM),
       "cuMemGetAllocationGranularity");
  Record r{0, place((int64_t)size, g_mode, (int64_t)gran), 0};
  must(cuMemAddressReserve(&r.base, (size_t)r.p.reserve, gran, 0, 0),
       "cuMemAddressReserve");
  if (r.p.mapped > 0) {
    const CUdeviceptr at = r.base + (CUdeviceptr)r.p.map_offset;
    must(cuMemCreate(&r.handle, (size_t)r.p.mapped, &prop, 0), "cuMemCreate");
    must(cuMemMap(at, (size_t)r.p.mapped, 0, r.handle, 0), "cuMemMap");
    CUmemAccessDesc access = {};
    access.location = prop.location;
    access.flags = CU_MEM_ACCESS_FLAGS_PROT_READWRITE;
    must(cuMemSetAccess(at, (size_t)r.p.mapped, &access, 1),
         "cuMemSetAccess");
    must(cuMemsetD8Async(at, g_fill, (size_t)r.p.mapped, (CUstream)stream),
         "cuMemsetD8Async");
    must(cuStreamSynchronize((CUstream)stream), "cuStreamSynchronize");
  }
  void *ptr = (void *)(r.base + (CUdeviceptr)r.p.offset);
  live[(uintptr_t)ptr] = r;
  ++n_allocs;
  ++n_live;
  bytes_live += r.p.mapped;
  if (n_live > peak_live) peak_live = n_live;
  if (bytes_live > peak_bytes) peak_bytes = bytes_live;
  return ptr;
}

void guard_free(void *ptr, ssize_t, int device, cudaStream_t) {
  std::lock_guard<std::mutex> lock(mu);
  const auto it = live.find((uintptr_t)ptr);
  if (it == live.end()) {
    fprintf(stderr, "[guard] free of %p, which this allocator never gave\n",
            ptr);
    fflush(stderr);
    abort();
  }
  const Record r = it->second;
  live.erase(it);
  --n_live;
  bytes_live -= r.p.mapped;
  cudaSetDevice(device);
  // a kernel on any stream may still use the mapping; after a fault the
  // context is gone, and the mapping goes with the process
  if (cuCtxSynchronize() != CUDA_SUCCESS) {
    ++n_free_errors;
    return;
  }
  if (r.p.mapped > 0) {
    must(cuMemUnmap(r.base + (CUdeviceptr)r.p.map_offset, (size_t)r.p.mapped),
         "cuMemUnmap");
    must(cuMemRelease(r.handle), "cuMemRelease");
  }
  must(cuMemAddressFree(r.base, (size_t)r.p.reserve), "cuMemAddressFree");
}

/* The positive control: one thread reads the byte at ptr + offset into
 * *out on `stream`; returns the launch's cudaError_t. A fault shows at the
 * next synchronisation. */
int guard_touch(const void *ptr, long long offset, void *out,
                cudaStream_t stream) {
  touch_kernel<<<1, 1, 0, stream>>>(
      static_cast<const volatile unsigned char *>(ptr) + offset,
      static_cast<unsigned char *>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
