/* paddle_tpu_torch custom-op C ABI (the same ABI as paddle_tpu's).
 *
 * The role of the reference's custom-operator extension ABI
 * (framework/custom_operator.cc, the PD_BUILD_OP macros).  A custom op is
 * C++ that runs on the host: the framework hands it host buffers, and a
 * tensor on the card is copied to the host for the call and its outputs
 * copied back (utils/cpp_extension.py).  Kernels for the card are written
 * in csrc/ and bound by the port itself.
 *
 * Contract per op <name> exported from the shared library:
 *   int pt_<name>_num_outputs(void);
 *   int pt_<name>_infer_shape(const int64_t* in_dims, const int32_t* in_ndims,
 *                             const int32_t* in_dtypes, int n_in,
 *                             int64_t* out_dims, int32_t* out_ndims,
 *                             int32_t* out_dtypes);   // dims arrays are
 *                                                     // PT_MAX_DIMS-strided
 *   int pt_<name>_forward(const PT_Tensor* ins, int n_in,
 *                         PT_Tensor* outs, int n_out);
 *   // optional — enables autograd through the op:
 *   int pt_<name>_backward(const PT_Tensor* ins_and_gradouts, int n_in,
 *                          PT_Tensor* grad_ins, int n_out);
 * plus one library-level symbol listing the ops:
 *   const char* pt_op_list(void);   // "relu2,my_gelu"
 * All functions return 0 on success.  Output buffers are allocated by the
 * framework from infer_shape results before forward/backward run.
 */
#ifndef PADDLE_TPU_EXT_H_
#define PADDLE_TPU_EXT_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define PT_MAX_DIMS 8

/* dtype codes (keep in sync with utils/cpp_extension.py _DTYPES) */
enum PT_DType {
  PT_FLOAT32 = 0,
  PT_FLOAT64 = 1,
  PT_INT32 = 2,
  PT_INT64 = 3,
  PT_UINT8 = 4,
  PT_BOOL = 5,
  PT_BFLOAT16 = 6,
};

typedef struct {
  void* data;
  int64_t dims[PT_MAX_DIMS];
  int32_t ndim;
  int32_t dtype;
} PT_Tensor;

static inline int64_t pt_numel(const PT_Tensor* t) {
  int64_t n = 1;
  for (int32_t i = 0; i < t->ndim; ++i) n *= t->dims[i];
  return n;
}

/* single-translation-unit convenience: PT_EXPORT_OPS("relu2,my_op") */
#define PT_EXPORT_OPS(names) \
  const char* pt_op_list(void) { return names; }

#ifdef __cplusplus
}
#endif

#endif /* PADDLE_TPU_EXT_H_ */
