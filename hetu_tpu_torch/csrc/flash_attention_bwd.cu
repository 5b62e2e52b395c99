// Flash attention backward for Hopper (sm_90a), float32: the C entries
// hetu_flash_bwd_{dq,dkv}[_causal,_bias,_mask] of the dQ and dK/dV kernels in
// flash_attention_bwd.cuh, which replace
// hetu_tpu/ops/pallas/flash_attention.py::_dq_kernel and ::_dkv_kernel.

#include "flash_attention_bwd.cuh"

HETU_BWD_ENTRIES(float, )
