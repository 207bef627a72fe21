// CUDA IPC between the processes that share one card: memory handles of the
// blocks a process exports, and interprocess events that order the exchange
// phases of neighbouring processes.
//
// Replaces no TPU kernel: it is the transport under B6's cross-process form
// (stencil_tpu/ops/remote_dma.py make_remote_axis_kernel, whose remote copies
// and neighbour barrier the TPU runs between chips), the counterpart of the
// reference's tx_ipc.cpp and tx_colocated.cu:45-153 (the receiver shares its
// quantity buffers, events carry the order). Python side:
// stencil_tpu_torch/parallel/ipc.py.
//
// A block's pointer may lie inside a larger allocation (PyTorch's caching
// allocator carves segments), and cudaIpcGetMemHandle names the whole
// allocation: ipc_mem_handle returns the handle of the allocation that holds
// the pointer and the pointer's offset into it (cuMemGetAddressRange, reached
// through libcuda.so.1 loaded at run time), and the opener adds the offset
// to the base that cudaIpcOpenMemHandle maps.
//
// Every entry returns a cudaError_t (0: success); a failure of the libcuda
// call is reported as cudaErrorUnknown.

#include <cuda_runtime.h>
#include <dlfcn.h>
#include <string.h>

namespace {

typedef int (*AddressRange)(unsigned long long*, size_t*, unsigned long long);

AddressRange address_range() {
  static AddressRange fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr) fn = reinterpret_cast<AddressRange>(dlsym(lib, "cuMemGetAddressRange_v2"));
  }
  return fn;
}

}  // namespace

// The handle (CUDA_IPC_HANDLE_SIZE = 64 bytes into `handle`) of the
// allocation holding `ptr`, and ptr's byte offset into it.
extern "C" int ipc_mem_handle(const void* ptr, void* handle, long long* offset) {
  AddressRange range = address_range();
  if (range == nullptr) return (int)cudaErrorUnknown;
  unsigned long long base = 0;
  size_t size = 0;
  if (range(&base, &size, (unsigned long long)ptr) != 0) return (int)cudaErrorUnknown;
  cudaIpcMemHandle_t h;
  cudaError_t err = cudaIpcGetMemHandle(&h, reinterpret_cast<void*>(base));
  if (err != cudaSuccess) return (int)err;
  memcpy(handle, &h, sizeof(h));
  *offset = (long long)((unsigned long long)ptr - base);
  return 0;
}

// Map another process's allocation into this one: *ptr its base here.
extern "C" int ipc_open_mem(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int ipc_close_mem(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

// An event other processes can wait on (no timing: an interprocess event
// must not time).
extern "C" int ipc_event_create(void** event) {
  cudaEvent_t ev;
  cudaError_t err = cudaEventCreateWithFlags(&ev, cudaEventInterprocess | cudaEventDisableTiming);
  *event = reinterpret_cast<void*>(ev);
  return (int)err;
}

extern "C" int ipc_event_handle(void* event, void* handle) {
  cudaIpcEventHandle_t h;
  cudaError_t err = cudaIpcGetEventHandle(&h, reinterpret_cast<cudaEvent_t>(event));
  if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return (int)err;
}

extern "C" int ipc_open_event(const void* handle, void** event) {
  cudaIpcEventHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaEvent_t ev;
  cudaError_t err = cudaIpcOpenEventHandle(&ev, h);
  *event = reinterpret_cast<void*>(ev);
  return (int)err;
}

extern "C" int ipc_event_record(void* event, void* stream) {
  return (int)cudaEventRecord(reinterpret_cast<cudaEvent_t>(event),
                              reinterpret_cast<cudaStream_t>(stream));
}

// The stream waits for the event's newest record issued before this call.
extern "C" int ipc_stream_wait(void* stream, void* event) {
  return (int)cudaStreamWaitEvent(reinterpret_cast<cudaStream_t>(stream),
                                  reinterpret_cast<cudaEvent_t>(event), 0);
}

extern "C" int ipc_event_destroy(void* event) {
  return (int)cudaEventDestroy(reinterpret_cast<cudaEvent_t>(event));
}
