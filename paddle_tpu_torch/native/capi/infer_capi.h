/* C inference API for paddle_tpu_torch saved programs.
 *
 * Reference parity: paddle/fluid/inference/capi_exp/ (PD_Predictor* C API
 * over the C++ AnalysisPredictor) and paddle/fluid/jit/ (C++ loader for
 * jit.save artifacts).
 *
 * Shape: the artifact is a torch.export program (jit.save) whose nodes
 * include the port's own registered operators (the flash-attention
 * forward), which are defined in Python; so the library EMBEDS the
 * CPython runtime that owns them and exposes this plain-C surface over
 * paddle_tpu_torch.inference. A non-Python serving process (see
 * tools/torch_infer_demo.c) links nothing but libc + this library and
 * never touches Python itself. Importing the port turns TF32 off, so a
 * float32 output equals the Python predictor's.
 *
 * Requirements at runtime: PYTHONPATH must let the embedded interpreter
 * import `paddle_tpu_torch` and `torch` (e.g. the repo root + the venv's
 * site-packages). The predictor runs on the card; PT_INFER_DEVICE=cpu in
 * the environment runs it on the CPU (Config.disable_gpu()).
 *
 * All arrays are float32. Single-threaded usage per predictor.
 */
#ifndef PADDLE_TPU_TORCH_INFER_CAPI_H_
#define PADDLE_TPU_TORCH_INFER_CAPI_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Load a jit.save artifact (path prefix). NULL on failure (call
 * PT_InferLastError for the message). */
void* PT_InferCreate(const char* artifact_prefix);

/* Number of graph inputs / outputs. */
int32_t PT_InferNumInputs(void* pred);
int32_t PT_InferNumOutputs(void* pred);

/* Run one inference on a single float32 input.
 *   input/shape/rank: the input tensor (C-contiguous)
 *   output: caller buffer of output_capacity floats
 *   out_shape: caller buffer of 8 int64s; out_rank receives the rank
 * Returns the number of output elements written, or <0 on error. */
int64_t PT_InferRun(void* pred, const float* input, const int64_t* shape,
                    int32_t rank, float* output, int64_t output_capacity,
                    int64_t* out_shape, int32_t* out_rank);

void PT_InferDestroy(void* pred);

/* Message for the most recent failure on this thread ("" if none). */
const char* PT_InferLastError(void);

#ifdef __cplusplus
}
#endif

#endif /* PADDLE_TPU_TORCH_INFER_CAPI_H_ */
