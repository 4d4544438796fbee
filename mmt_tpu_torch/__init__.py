"""mmt_tpu_torch: the PyTorch + CUDA port of mmt_tpu for NVIDIA Hopper.

The slice ported so far is the eval path: the flagship CENet's forward
(models/), the MoE similarity and the retrieval ranks and metrics
(ops/, train/metrics.py, evaluate.py).  Two hand-written sm_90a CUDA
kernels carry it on the card: the fused FFN block (ops/ffn.py,
csrc/ffn_block.cu) and the fused MoE similarity (ops/similarity.py,
csrc/moe_similarity.cu).  _build.py compiles them with nvcc at first use.
The package imports torch and never jax.
"""

__version__ = "0.1.0"
