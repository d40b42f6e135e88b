"""lachain_tpu_torch: the PyTorch/CUDA port of lachain_tpu's device crypto.

Slice 1 carries the TPKE era verify+combine path: the BLS12-381 G1 kernels
(csrc/g1.cu, bound in ops/g1.py), the era pipeline (ops/verify.py) and
`crypto.gpu_backend.GpuBackend`. The package imports torch and numpy and
nothing of JAX or of lachain_tpu. Its entry points run on the card unless
the caller passes device="cpu".
"""
