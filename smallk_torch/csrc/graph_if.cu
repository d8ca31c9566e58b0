// Conditional IF nodes in a CUDA graph under stream capture, for Hopper
// (sm_90a; conditional nodes need CUDA 12.4 or later).
//
// Replaces no TPU kernel.  It is the port's form of the test of the JAX
// package's lax.while_loop (smallk_tpu/solvers/nnls.py:557-559): the BPP
// pivot loop's predicate is a device value, and a captured step must test
// it on the device.  solvers/graph.py:IfNest drives it: round r + 1 of the
// pivot loop is captured inside the IF node of round r, so once the test
// fails the node skips every later round.
//
// smallk_if_begin, with `from` a stream under capture (the step's capture
// stream, or the body stream capturing round r's body):
//   1. a conditional handle in the graph `from` captures into;
//   2. smallk_set_condition, a one-thread kernel captured on `from`, sets
//      the handle from the bool at `pred` each time the graph runs;
//   3. an IF node after it, whose one body graph CUDA allocates;
//   4. `from`'s capture continues after the IF node; where `from` is the
//      body stream itself, its capture of round r's body ends there (the
//      IF node is that body's last node);
//   5. `body` begins capturing into the IF node's body graph.
// smallk_if_end ends the capture of the innermost body.  One body stream
// serves every level of a nest: a level's capture ends before the next
// begins.  The launches are tiny and the kernel is bound by its launch.
//
// The API (cudaGraphConditionalHandleCreate, cudaGraphAddNode with
// cudaGraphNodeTypeConditional, cudaStreamBeginCaptureToGraph,
// cudaGraphSetConditional on the device) is the CUDA runtime's own; the
// library has a plain C interface and no PyTorch headers.

#include <cuda_runtime.h>

namespace {

__global__ void smallk_set_condition(cudaGraphConditionalHandle handle,
                                     const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the IF node was added and `body` captures
// into its body graph.
int smallk_if_begin(void* from, const void* pred, void* body, int device) {
  cudaStream_t s = (cudaStream_t)from;
  cudaStream_t b = (cudaStream_t)body;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureUnmatched;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  smallk_set_condition<<<1, 1, 0, s>>>(handle, (const bool*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // the set kernel is now the capture's one dependency
  err = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body_graph = params.conditional.phGraph_out[0];
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  if (s == b) {
    cudaGraph_t done = nullptr;
    err = cudaStreamEndCapture(s, &done);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaStreamBeginCaptureToGraph(b, body_graph, nullptr, nullptr,
                                            0,
                                            cudaStreamCaptureModeThreadLocal);
}

// Ends the capture of the innermost body on `body`.
int smallk_if_end(void* body, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t done = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)body, &done);
}

// A stream of the port's own (not from PyTorch's pool, whose streams are
// handed out in turn), written to *out.
int smallk_stream_create(void** out, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamCreateWithFlags((cudaStream_t*)out,
                                        cudaStreamNonBlocking);
}

const char* smallk_if_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
