// CUDA-graph IF nodes built during a stream capture: the device side of
// a one-lane `lax.cond` (mmloam_tpu_torch/branch.py).
//
// The reference's unbatched step runs each `lax.cond` as an XLA
// conditional: the device reads the predicate and runs one branch, with
// no host read.  The counterpart in a captured CUDA graph is a
// conditional IF node, whose body graph runs where the node's handle
// was set to a nonzero value at that replay.  `if_node_begin` adds such
// a node to the graph that `stream` is capturing into, preceded by a
// one-thread kernel that sets the handle from a device bool, and starts
// capturing `body_stream` into the node's body; `if_node_end` ends that
// body capture.  Bodies nest: a body stream that captures may itself be
// the `stream` of a further node.  This replaces no TPU kernel (XLA's
// conditional was not a Pallas kernel); it is what torch builds for
// `torch.cond` under a graph capture in its later releases, written
// here because the port's torch may not have it.
//
// Both functions return 0 or the CUDA error; -1 where `stream` is not
// capturing.  An error is returned, not left as the thread's last error
// too (`fail`): a later launch check (`cudaGetLastError`, as after the
// handle kernel here) would read it, and a capture after a failed one
// would fail at its first node.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, nullptr,
                                  n);
#else
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, n);
#endif
}

int fail(cudaError_t err) {
  cudaGetLastError();
  return err;
}

}  // namespace

extern "C" int if_node_begin(void* stream, void* body_stream,
                             const void* pred,
                             unsigned long long* body_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  cudaError_t err = capture_info(s, &status, &graph, &deps, &n);
  if (err != cudaSuccess) return fail(err);
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return fail(err);
  set_if_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return fail(err);
  // the node depends on what the stream's capture ends in now: the kernel
  err = capture_info(s, &status, &graph, &deps, &n);
  if (err != cudaSuccess) return fail(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
#endif
  if (err != cudaSuccess) return fail(err);
  // what the stream captures next depends on the node
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return fail(err);
  cudaGraph_t body = params.conditional.phGraph_out[0];
  err = cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), body, nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return fail(err);
  *body_out = reinterpret_cast<unsigned long long>(body);
  return 0;
}

extern "C" int if_node_end(void* body_stream) {
  cudaGraph_t body;
  cudaError_t err =
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
  return err == cudaSuccess ? 0 : fail(err);
}
