"""pointnet12_tpu_torch: the PyTorch + CUDA port of ``pointnet12_tpu``.

It runs on one NVIDIA H100 (``sm_90a``) and keeps the JAX package's
layout and module names, so each counterpart is found at the same path.
The JAX package stays the reference; this package never imports it, nor
JAX. Tensors are channels-last ``(B, N, C)`` at every public function.

Ported so far: ``pointnet2_semseg`` in fp32, bf16 and bf16 with
stochastic rounding, its serving path (eval forward), its train and eval
steps, with the train-mode BN statistics optionally fused into the
matmul, and precise BN; the fused eval set abstraction (``impl="fused"``)
and the grid ball query of large clouds. The entry points run on the card
unless asked for the CPU.

Layer map:
  infer.py  L4 Predictor (BN folded once), pad_batch
  train/    L4 train and eval steps, losses, metrics, optimizer + StepLR,
            precise BN
  models/   L3 pointnet2_semseg
  nn/       L2 SharedMLP / GroupedSharedMLP (train: batch-statistics BN,
            plain or fused, and the lifted first Dense's custom backward;
            eval: BN folded; bf16 casts, stochastic in train with sr),
            SetAbstraction (SSG, and the fused eval branch), FeaturePropagation
  ops/      L1 point ops with their plain PyTorch versions: distance,
            gather, FPS, ball query (scan or voxel grid), the grid's prep,
            3-NN + interpolation (custom backward), the segment sum of the
            backward, Dense + BN statistics (custom backward), the fused
            eval SA layer
  kernels/  L1 wrappers of the CUDA kernels (launch counters), dispatch,
            the nvcc build, the kernel-vs-plain comparison masks
  csrc/     L0 CUDA C++ sources: fps.cu (any N, one block a cloud),
            ballquery.cu, grid_prep.cu (the grid's bounds, sorts and cell
            offsets in one launch), ballquery_grid.cu, fused_sa.cu,
            threenn.cu, segsum.cu, bn_stats.cu; neighbours.cuh, the
            searches they share
  utils/    JAX -> PyTorch weight conversion, device and precision checks

Importing the package loads no kernel and calls no compiler: the kernels
are built from ``csrc/`` at their first launch.
"""

__version__ = "0.1.0"
