// CUDA-graph WHILE nodes for a capture that PyTorch's CUDAGraph is making.
//
// Replaces the device-side loop of pytorch_nmf_tpu/ops/solver.py's
// backtracking line search (_backtrack_project, :678-711): a lax.while_loop
// under jax.jit, whose "try again" test never leaves the TPU.  The port
// captures its Hoyer fit's chunk loop in a CUDA graph
// (ops/solver.py::get_hoyer_fit on ops/graphs.py::_Graphs); the attempts
// after the first are the body of a WHILE node whose condition the card
// reads from a 0-d bool tensor ("the last attempt was worse, and fewer
// than 10 were made") before the first run of the body and after each, so
// a replayed loop takes the attempts the data takes and makes no host
// read.  PyTorch 2.13 has IF nodes as CUDAGraph methods
// (begin_capture_to_if_node); the PyTorch this port runs on need not, and
// a WHILE node is one body captured once where IF nodes need one per
// attempt.
//
// pnt_while_begin, called while `stream` is being captured:
//   1. a conditional handle on the graph being captured (*handle_out);
//   2. a one-thread kernel, captured on `stream`, that sets the handle from
//      *pred (read on the card each time the graph runs);
//   3. a WHILE node after it, made the stream's only dependency;
//   4. `body` starts capturing into the WHILE node's body graph.
// The caller then enqueues the body's work on `body`, which updates *pred,
// and calls pnt_while_end, which captures the same handle-setting kernel
// at the end of the body and ends that capture; `stream`'s capture goes on
// after the WHILE node.  A body being captured may open WHILE nodes of its
// own, on another stream: `stream` is then the body's, and the handle is
// made on the body's graph (the fits' chunk loop holds the line searches'
// so; the caller gives each nesting depth its own body stream).
// Each returns a CUDA error code (0 on success;
// cudaErrorStreamCaptureImplicit when `stream` is not capturing).
//
// CUDA 12.4 is the least runtime with conditional nodes; from CUDA 13 the
// capture calls take edge data (passed as none here).

#include <cuda_runtime.h>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12040
#error "CUDA-graph conditional nodes need CUDA 12.4 or later"
#endif

__global__ void pnt_set_condition_kernel(cudaGraphConditionalHandle handle,
                                         const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

static cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* st,
                                cudaGraph_t* graph,
                                const cudaGraphNode_t** deps, size_t* n) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, st, nullptr, graph, deps, nullptr, n);
#else
  return cudaStreamGetCaptureInfo(s, st, nullptr, graph, deps, n);
#endif
}

extern "C" {

int pnt_while_begin(void* stream_, const void* pred, void* body_,
                    unsigned long long* handle_out) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaStream_t body = static_cast<cudaStream_t>(body_);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t e = capture_info(stream, &status, &graph, &deps, &n);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  *handle_out = handle;
  pnt_set_condition_kernel<<<1, 1, 0, stream>>>(
      handle, static_cast<const bool*>(pred));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the dependencies now end at the handle-setting kernel
  e = capture_info(stream, &status, &graph, &deps, &n);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                          cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return e;
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeGlobal);
}

int pnt_while_end(void* body_, unsigned long long handle, const void* pred) {
  cudaStream_t body = static_cast<cudaStream_t>(body_);
  pnt_set_condition_kernel<<<1, 1, 0, body>>>(
      handle, static_cast<const bool*>(pred));
  cudaError_t launched = cudaGetLastError();
  cudaGraph_t graph;  // the WHILE node's body graph, which the node owns
  cudaError_t e = cudaStreamEndCapture(body, &graph);
  return launched != cudaSuccess ? launched : e;
}

// A stream of the caller's own for the bodies' captures (PyTorch's pooled
// streams are shared round-robin, so one of them may be the stream being
// captured, or another thread's).
int pnt_stream_create(void** out) {
  cudaStream_t s = nullptr;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return e;
}

int pnt_stream_destroy(void* s) {
  return cudaStreamDestroy(static_cast<cudaStream_t>(s));
}

}  // extern "C"
