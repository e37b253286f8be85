// ------------------------------------------------------------------
// Span marks: empty kernels that mark the boundaries of the port's step
// on the device timeline (utils/spans.py).
//
// Each span <name> has a begin kernel idee_span_<name>_begin and an end
// kernel idee_span_<name>_end, declared extern "C" so that the profiler
// shows their names as they are, and a C launcher
// idee_span_launch_<name>_<edge>(stream) that runs the kernel <<<1, 1>>>
// on the stream and returns the launch's cudaError. Under CUDA-graph
// capture each launch becomes a kernel node of the graph, so every replay
// emits the marks. The list below is utils/spans.py::NAMES.
// ------------------------------------------------------------------

#include <cuda_runtime.h>

#define IDEE_SPAN_EDGE(name, edge)                                       \
  extern "C" __global__ void idee_span_##name##_##edge() {}             \
  extern "C" int idee_span_launch_##name##_##edge(void* stream) {       \
    idee_span_##name##_##edge<<<1, 1, 0, (cudaStream_t)stream>>>();     \
    return (int)cudaGetLastError();                                     \
  }

#define IDEE_SPAN(name) IDEE_SPAN_EDGE(name, begin) IDEE_SPAN_EDGE(name, end)

IDEE_SPAN(step)
IDEE_SPAN(data)
IDEE_SPAN(encoder)
IDEE_SPAN(quantizer)
IDEE_SPAN(classifier)
IDEE_SPAN(loss)
IDEE_SPAN(backward)
IDEE_SPAN(encoder_backward)
IDEE_SPAN(grad_sync)
IDEE_SPAN(optimizer)
IDEE_SPAN(accumulate)
