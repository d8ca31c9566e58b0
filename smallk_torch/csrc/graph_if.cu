// Conditional WHILE nodes in a CUDA graph under stream capture, for Hopper
// (sm_90a; conditional nodes need CUDA 12.4 or later).
//
// Replaces no TPU kernel.  It is the port's form of the JAX package's
// lax.while_loop (smallk_tpu/solvers/nnls.py:184-205, the masked CG loop,
// and :557-590 with :724, the BPP pivot loop): a loop whose trip count is
// a device value, with one body in the graph.  solvers/graph.py:WhileLoop
// drives it.  The launches are tiny and bound by their launch.
//
// smallk_while_begin, with `from` a stream under capture (the step's
// capture stream, or the body stream of the loop that holds this one):
//   1. a conditional handle in the graph `from` captures into;
//   2. smallk_set_condition, a one-thread kernel captured on `from`, sets
//      the handle from the loop's first test (the bool at `pred`) each
//      time the graph runs: the handle is made without
//      cudaGraphCondAssignDefault, so nothing else resets it, and a value
//      left by the last launch would otherwise decide the first trip;
//   3. a WHILE node after it, whose one body graph CUDA allocates;
//   4. `from`'s capture continues after the WHILE node;
//   5. `body` begins capturing into the node's body graph.
// smallk_while_end captures, last in the body, the set kernel on the next
// test, and ends the body's capture.  The node runs its body while the
// handle is not 0.  `body` must be another stream than `from`: a loop
// inside a body takes the stream of the next level, and the outer body's
// capture goes on after the inner node (step 4).
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

// The graph `s` captures into, and the nodes its next capture depends on.
cudaError_t capture_graph(cudaStream_t s, cudaGraph_t* graph,
                          const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, &id, graph, deps, n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureUnmatched;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the WHILE node was added, its handle
// written to *handle, and `body` captures into its body graph.
int smallk_while_begin(void* from, const void* pred, void* body, int device,
                       unsigned long long* handle) {
  cudaStream_t s = (cudaStream_t)from;
  cudaStream_t b = (cudaStream_t)body;
  if (s == b) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = capture_graph(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;

  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  smallk_set_condition<<<1, 1, 0, s>>>(h, (const bool*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // the set kernel is now the capture's one dependency
  err = capture_graph(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = h;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body_graph = params.conditional.phGraph_out[0];
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  *handle = h;
  return (int)cudaStreamBeginCaptureToGraph(b, body_graph, nullptr, nullptr,
                                            0,
                                            cudaStreamCaptureModeThreadLocal);
}

// Ends the capture of a WHILE body on `body`, after the set kernel that
// writes the next test (the bool at `pred`) into the node's handle.  With
// `pred` null (a body whose capture failed) it only ends the capture.
int smallk_while_end(void* body, const void* pred, unsigned long long handle,
                     int device) {
  cudaStream_t b = (cudaStream_t)body;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaError_t set = cudaSuccess;
  if (pred != nullptr) {
    smallk_set_condition<<<1, 1, 0, b>>>(
        (cudaGraphConditionalHandle)handle, (const bool*)pred);
    set = cudaGetLastError();
  }
  cudaGraph_t done = nullptr;
  err = cudaStreamEndCapture(b, &done);
  return (int)(set != cudaSuccess ? set : err);
}

// The nodes of the graph that `stream` captures into, so far, written to
// *out (a conditional node counts as one; its body is a graph of its own).
int smallk_capture_nodes(void* stream, int device, unsigned long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = capture_graph((cudaStream_t)stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  *out = n;
  return (int)err;
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
