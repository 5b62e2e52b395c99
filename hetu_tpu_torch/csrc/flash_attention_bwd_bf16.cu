// Flash attention backward for Hopper (sm_90a), bfloat16 dQ: the C entries
// hetu_flash_bwd_dq[_causal,_bias,_mask]_bf16 of the SIMT dQ kernel in
// flash_attention_bwd.cuh, the TPU kernel's bf16 instantiation of
// hetu_tpu/ops/pallas/flash_attention.py::_dq_kernel.  The bf16 dK/dV
// entries run on the tensor cores (flash_attention_dkv_bf16.cu).

#include <cuda_bf16.h>

#include "flash_attention_bwd.cuh"

HETU_BWD_DQ_ENTRIES(__nv_bfloat16, _bf16)
