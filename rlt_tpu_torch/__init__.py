"""rlt_tpu_torch: the PyTorch/CUDA port of rlt_tpu for an NVIDIA H100.

It imports torch, numpy and the standard library only, never JAX or the
rlt_tpu package. Its entry points (`infer.Predictor`, `serve`) run on the
CUDA card unless the caller asks for the CPU; on a CUDA tensor each ported
kernel is a hand-written CUDA kernel (`rlt_tpu_torch/csrc`), on a CPU tensor
its plain PyTorch version runs. ROADMAP.md says what is ported so far.
"""
