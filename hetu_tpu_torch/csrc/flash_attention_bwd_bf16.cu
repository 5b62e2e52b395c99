// Flash attention backward for Hopper (sm_90a), bfloat16: the C entries
// hetu_flash_bwd_{dq,dkv}[_causal,_bias,_mask]_bf16 of the dQ and dK/dV
// kernels in flash_attention_bwd.cuh, the TPU kernels' bf16 instantiation of
// hetu_tpu/ops/pallas/flash_attention.py::_dq_kernel and ::_dkv_kernel.

#include <cuda_bf16.h>

#include "flash_attention_bwd.cuh"

HETU_BWD_ENTRIES(__nv_bfloat16, _bf16)
