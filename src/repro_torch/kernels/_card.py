"""What the hand-written kernels size themselves against on the card.

One place for the limits that every kernel's legality and proxy problem
read, so no kernel module learns them from another, and for the route a
tensor takes to a kernel.
"""

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import _get_current_dispatch_mode

#: opt-in shared memory per block of the H100 (bytes): the staging limit
#: legality checks against when no card is asked about
H100_SMEM_OPTIN = 232_448
#: thread blocks a proxy problem launches (about two per SM of the H100's
#: 132), so a config is timed in throughput, not one block's latency
PROXY_BLOCKS = 256


def card_smem(t: torch.Tensor) -> int:
    """The opt-in shared memory per block of ``t``'s card; for a fake
    tensor (a traced step holds no card) the H100's, the card the port is
    written for."""
    if is_fake(t):
        return H100_SMEM_OPTIN
    return torch.cuda.get_device_properties(
        t.device).shared_memory_per_block_optin


def plain_route(t: torch.Tensor) -> bool:
    """Whether ``t`` takes a kernel's plain version directly: a real CPU
    tensor.  CUDA and fake tensors go through the kernel's
    ``torch.library`` operator."""
    return t.device.type == "cpu" and not is_fake(t)


def card_call(op, launch, *args):
    """A kernel call on CUDA or fake tensors: through its operator where
    the dispatcher must see it (fake tensors; any dispatch mode on, such
    as a traced step's, a selective checkpoint's or a counter's), else
    the launch itself.  A decode step is host-bound: the operator's
    dispatch costs more host time than the launch."""
    if is_fake(args[0]) or _get_current_dispatch_mode() is not None:
        return op(*args)
    return launch(*args)
