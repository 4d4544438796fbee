"""mmt_tpu_torch: the PyTorch + CUDA port of mmt_tpu for NVIDIA Hopper.

The slices ported so far are the eval path (the flagship CENet's
forward in models/, the MoE similarity and the retrieval ranks and
metrics in ops/, train/metrics.py, evaluate.py) and the train step
(train/step.py, train/losses.py, train/optim.py, dropout and train-mode
BatchNorm in models/), both also under tensor parallelism (parallel/,
the Megatron layout over torch.distributed), and the training entry
point (cli.py, ``python -m mmt_tpu_torch.train``: the data side in
data/, tokenization.py, config.py, checkpoints and the trainer in
train/, the pretrained text-tower init from hf_bert.py), serving
(serving.py, serve.py), and the JAX package's msgpack files
(serialization.py, convert.py).  Hand-written sm_90a CUDA
kernels carry them on the card: the fused FFN block, eval and train
forward and their tensor-parallel partials (ops/ffn.py,
csrc/ffn_block.cu), its backward (csrc/ffn_train_bwd.cu), the fused MoE
similarity (ops/similarity.py, csrc/moe_similarity.cu) and the fused
ranks (ops/ranking.py, csrc/fused_ranks.cu).  _build.py compiles them
with nvcc at first use.  The package imports torch and never jax.
"""

__version__ = "0.1.0"
