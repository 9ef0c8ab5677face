"""PyTorch + CUDA port of MeMOTR-TPU (streaming inference of the deformable
model), beside the JAX reference package ``memotr_tpu``.  Imports torch and
numpy only, never JAX."""
