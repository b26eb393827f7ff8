// CUDA graph conditional nodes (IF and WHILE) built through the runtime API,
// for a stream that is being captured into a CUDA graph.
//
// IF: the tiered history's lazy merge runs only when the run stack is full,
// a predicate the step computes on the card (the JAX package's lax.cond in
// _tiered_apply). A captured graph cannot branch on the host, and computing
// the merge every step and selecting its result would cost more than the
// monolithic table. So the merge is the body of an IF node: the graph holds
// a one-thread kernel that copies the 0-d bool predicate into the node's
// conditional handle, then the node, whose body graph runs only when the
// handle is nonzero.
//
// WHILE: the device-resident server step runs a runtime number of chunks
// (the JAX package's lax.while_loop in resolve_server_loop). The same set
// kernel writes the first condition before the node; the body ends with
// another launch of it, which writes the condition the next iteration tests.
//
// A conditional node may sit inside another's body: the capturing stream is
// then the outer node's body stream. Conditional nodes need CUDA 12.4 or
// later, nesting 12.4 or later.
//
//   fdb_cond_begin(parent, body, pred, type, handle_out): on the capturing
//     stream `parent`, create a conditional handle in the graph being
//     captured, capture the set kernel, add the node (type 0 = IF, 1 =
//     WHILE) after it, make the node the parent's capture dependency, and
//     start capturing `body` (an idle stream) into the node's body graph;
//     the handle goes to *handle_out;
//   fdb_cond_set(stream, handle, pred): capture the set kernel on `stream`
//     (a WHILE body's last step);
//   fdb_cond_end(body): end the body's capture.
//   fdb_cond_init(): load the set kernel's module outside any capture.
//
// Every call returns a cudaError_t as int (0 = success).
#include <cuda_runtime.h>

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int fdb_cond_init() {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, set_conditional_kernel));
}

extern "C" int fdb_cond_set(void* stream, unsigned long long handle, const void* pred) {
  set_conditional_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), static_cast<const bool*>(pred));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fdb_cond_begin(void* parent_stream, void* body_stream, const void* pred, int type,
                              unsigned long long* handle_out) {
  cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureUnmatched);
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *handle_out = static_cast<unsigned long long>(handle);
  set_conditional_kernel<<<1, 1, 0, parent>>>(handle, static_cast<const bool*>(pred));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamUpdateCaptureDependencies(parent, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeRelaxed));
}

extern "C" int fdb_cond_end(void* body_stream) {
  cudaGraph_t body;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}
