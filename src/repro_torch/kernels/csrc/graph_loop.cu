// Device-side control flow for core.device_loop: CUDA-graph conditional
// nodes (WHILE and IF) around graphs that PyTorch captured.
//
// The JAX package's core.while_loop and lax.cond decide on the device:
// XLA compiles the predicate, the body and both branches into one program
// and the TPU runs the loop without returning to the host. Here a loop is
// one CUDA graph that the host launches once:
//
//     outer:  [cond graph] -> set(h, pred) -> WHILE(h) {
//                 [body pieces] -> [cond graph] -> set(h, pred) }
//
// where each [.. graph] is a child-graph node holding a graph that PyTorch
// captured (its allocations already routed to a graph pool), and set() is
// a one-thread kernel node that reads a 0-d int32 predicate on the device
// and calls cudaGraphSetConditional. A body piece is a captured graph or
// an IF node built the same way (set(h', pred') -> IF(h') { pieces }), so
// core.cond(backend="graph") runs exactly one branch without a host read.
//
// Not a port of a TPU kernel: the one kernel here is a single thread. The
// cost that matters is the host's: a segment of N iterations costs one
// cudaGraphLaunch instead of N iterations of eager launches and a
// predicate read each.
//
// The same library holds the push and pop of core.stacks.CarryStack under
// carry_offload: a copy of one carry leaf between a device tensor and row
// k of a stack in pinned host memory that the device addresses directly,
// with k read from device memory. A graph memcpy node has fixed addresses,
// so the row offset, known only on the device, needs a kernel. It is not a
// port of a TPU kernel (the JAX package leaves the pinned_host transfer to
// XLA); it is bound by the PCIe link, and moves 16 bytes a thread where
// the two addresses and the size allow it.
//
// Every entry returns a cudaError_t (0 on success), the API call's own
// error or cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const int* pred, int negate) {
  unsigned int v = *pred != 0 ? 1u : 0u;
  cudaGraphSetConditional(handle, negate ? 1u - v : v);
}

// dst[0:nbytes] = src[0:nbytes], with the host side at row *k of a
// stack of rows `stride` bytes apart (to_host: dst is the stack).
__global__ void stack_copy_kernel(char* dst, const char* src,
                                  const long long* k, long long stride,
                                  long long nbytes, int to_host) {
  const long long off = *k * stride;
  char* d = to_host ? dst + off : dst;
  const char* s = to_host ? src : src + off;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s) |
        static_cast<uintptr_t>(nbytes)) & 15) == 0) {
    uint4* dv = reinterpret_cast<uint4*>(d);
    const uint4* sv = reinterpret_cast<const uint4*>(s);
    for (long long i = first; i < (nbytes >> 4); i += step) dv[i] = sv[i];
  } else {
    for (long long i = first; i < nbytes; i += step) d[i] = s[i];
  }
}

#define RETURN_IF(call)                    \
  do {                                     \
    cudaError_t err_ = (call);             \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

// Dependencies of a node appended after *tail (none when *tail is null).
inline const cudaGraphNode_t* deps(const cudaGraphNode_t* tail) {
  return *tail ? tail : nullptr;
}
inline size_t n_deps(const cudaGraphNode_t* tail) { return *tail ? 1 : 0; }

}  // namespace

extern "C" {

int graph_loop_create(cudaGraph_t* graph) {
  RETURN_IF(cudaGraphCreate(graph, 0));
  return cudaGetLastError();
}

// The number of nodes in `graph` (an empty capture adds nothing).
int graph_loop_node_count(cudaGraph_t graph, size_t* count) {
  RETURN_IF(cudaGraphGetNodes(graph, nullptr, count));
  return cudaGetLastError();
}

// A conditional handle owned by `graph`, the graph that will hold the
// conditional node (the outer graph for the loop, a body for an IF).
int graph_loop_handle(cudaGraph_t graph,
                      cudaGraphConditionalHandle* handle) {
  RETURN_IF(cudaGraphConditionalHandleCreate(handle, graph, 0, 0));
  return cudaGetLastError();
}

// Append a child-graph node holding a clone of `child` after *tail.
int graph_loop_add_child(cudaGraph_t graph, cudaGraphNode_t* tail,
                         cudaGraph_t child) {
  cudaGraphNode_t node;
  RETURN_IF(cudaGraphAddChildGraphNode(&node, graph, deps(tail),
                                       n_deps(tail), child));
  *tail = node;
  return cudaGetLastError();
}

// Append set(handle, pred, negate): the handle's value becomes
// (*pred != 0), or its negation.
int graph_loop_add_set(cudaGraph_t graph, cudaGraphNode_t* tail,
                       cudaGraphConditionalHandle handle, const int* pred,
                       int negate) {
  void* args[] = {&handle, &pred, &negate};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(set_condition);
  p.gridDim = dim3(1, 1, 1);
  p.blockDim = dim3(1, 1, 1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  cudaGraphNode_t node;
  RETURN_IF(cudaGraphAddKernelNode(&node, graph, deps(tail), n_deps(tail),
                                   &p));
  *tail = node;
  return cudaGetLastError();
}

// Append a conditional node on `handle`: kind 0 = IF, 1 = WHILE. Its body
// graph (owned by the node) comes back in *body, empty, for the caller to
// fill.
int graph_loop_add_conditional(cudaGraph_t graph, cudaGraphNode_t* tail,
                               cudaGraphConditionalHandle handle, int kind,
                               cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = kind ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaGraphNode_t node;
  RETURN_IF(cudaGraphAddNode(&node, graph, deps(tail), n_deps(tail), &p));
  *body = p.conditional.phGraph_out[0];
  *tail = node;
  return cudaGetLastError();
}

int graph_loop_instantiate(cudaGraph_t graph, cudaGraphExec_t* exec) {
  RETURN_IF(cudaGraphInstantiate(exec, graph, 0));
  return cudaGetLastError();
}

// Upload the executable graph's resources ahead of its first launch.
int graph_loop_upload(cudaGraphExec_t exec, cudaStream_t stream) {
  RETURN_IF(cudaGraphUpload(exec, stream));
  return cudaGetLastError();
}

int graph_loop_launch(cudaGraphExec_t exec, cudaStream_t stream) {
  RETURN_IF(cudaGraphLaunch(exec, stream));
  return cudaGetLastError();
}

// Destroy what graph_loop_create and graph_loop_instantiate made (either
// may be null).
int graph_loop_destroy(cudaGraph_t graph, cudaGraphExec_t exec) {
  if (exec) RETURN_IF(cudaGraphExecDestroy(exec));
  if (graph) RETURN_IF(cudaGraphDestroy(graph));
  return cudaGetLastError();
}

// The device address of pinned host memory at `host` (PyTorch's pinned
// blocks come from cudaHostAlloc; under unified addressing they are mapped).
// Fails with cudaErrorInvalidValue where the memory is not mapped host
// memory.
int stack_device_pointer(void* host, void** device) {
  cudaPointerAttributes attr;
  RETURN_IF(cudaPointerGetAttributes(&attr, host));
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return cudaErrorInvalidValue;
  *device = attr.devicePointer;
  return cudaGetLastError();
}

// One push (to_host = 1: host row *k <- device src) or pop (to_host = 0:
// device dst <- host row *k) of a CarryStack in pinned host memory;
// `host` is the stack's device address (stack_device_pointer).
int stack_copy(void* device, void* host, const long long* k,
               long long stride, long long nbytes, int to_host,
               cudaStream_t stream) {
  const int threads = 256;
  long long work = (nbytes + 15) / 16;
  int blocks = static_cast<int>((work + threads - 1) / threads);
  blocks = blocks < 1 ? 1 : (blocks > 1056 ? 1056 : blocks);
  char* dst = static_cast<char*>(to_host ? host : device);
  const char* src = static_cast<const char*>(to_host ? device : host);
  stack_copy_kernel<<<blocks, threads, 0, stream>>>(dst, src, k, stride,
                                                    nbytes, to_host);
  return cudaGetLastError();
}

}  // extern "C"
