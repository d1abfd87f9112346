"""flow_tpu_torch: the PyTorch/CUDA port of flow_tpu.

The module tree mirrors ``flow_tpu`` so each port module sits at the same
relative path as its JAX counterpart. The port imports neither ``jax`` nor
``flow_tpu``. Setup (meshes, dof maps, reference tensors) runs in numpy on the
host; the finished tables move to the device once.

TF32 is switched off here for the whole process: cuDNN would otherwise run the
float32 multigrid transfer convolutions with about three decimal digits, the
same trap as the TPU's default bf16 convolution passes.
"""
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

__all__ = []
