"""The port's hand-written CUDA kernels, their wrappers and their plain
PyTorch versions (what a wrapper runs on CPU tensors, and on meta tensors,
where they only propagate shapes: ``PLAIN_DEVICES``).

On import, one small ``torch.exp`` on this thread: torch's CPU build
settles which vector implementation of its math functions to run on the
first such call of a process, and a first call split over several
threads can compute some threads' shares before that is settled.  That
was seen with torch 2.13's CPU build: in about one process of two, a
first ``exp`` of 2M f32 values came out up to 1.1e-4 off on a quarter of
them, enough to fail ``ssm_scan_plain`` against the Pallas kernel at
1e-4.  Any vectorised math call settles it for the others (``log``
likewise), so the plain versions below never make the first one.
"""
import torch

torch.exp(torch.zeros(16))

# The devices whose tensors take a kernel's plain version: the CPU (the
# tests, CPU runs) and the meta device (the dry-run's trace: the plain
# version only propagates shapes there).  A CUDA tensor launches the
# kernel or raises.
PLAIN_DEVICES = ("cpu", "meta")


def _plain_device(x: torch.Tensor) -> bool:
    return x.device.type in PLAIN_DEVICES
