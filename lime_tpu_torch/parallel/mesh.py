"""The (sp, dp) mesh over torch.distributed ranks, and its collectives.

A JAX shard on device ``(sp_i, dp_j)`` of ``lime_tpu``'s mesh becomes one
rank here, numbered ``c = sp_i * dp + dp_j``: the row-major order
``lime_tpu.parallel.mesh.make_mesh`` reshapes its devices into, so shard
``c`` of a stream sharded ``P(None, ("sp", "dp"))`` is rank ``c``'s.

- ``lax.psum_scatter(..., "dp", tiled=True)`` becomes
  ``reduce_scatter_tensor`` over the rank's dp group (the ranks with its
  ``sp_i``);
- ``lax.psum(..., "sp")`` becomes ``all_reduce`` over its sp group (the
  ranks with its ``dp_j``);
- ``ppermute`` halos and ``process_allgather`` become ``all_gather`` over
  every rank (:meth:`Mesh.all_gather`).

Without a process group the mesh is 1x1 and every collective is the
identity.  Several ranks can share one card on the gloo backend (NCCL
refuses two ranks on one device): gloo in torch 2.11 takes CUDA tensors
in every collective used here, int8 sums wrapping mod 256, so nothing is
staged through the host by this module.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (sp, dp) mesh and its process groups."""

    shape: dict            # {"sp": sp, "dp": dp}
    rank: int
    world: int
    sp_group: object = None  # the ranks with this dp_j (psum over sp)
    dp_group: object = None  # the ranks with this sp_i (psum_scatter over dp)

    @property
    def sp_i(self) -> int:
        return self.rank // self.shape["dp"]

    @property
    def dp_j(self) -> int:
        return self.rank % self.shape["dp"]

    @property
    def distributed(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend() if self.distributed else None

    def comm_device(self, device: torch.device) -> torch.device:
        """Where host data travels through a collective: the rank's card
        on NCCL, the CPU on gloo."""
        return device if self.backend == "nccl" else torch.device("cpu")

    def all_reduce_sp(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the sp group in place (int8 wraps mod 256)."""
        if self.distributed:
            dist.all_reduce(tensor, group=self.sp_group)
        return tensor

    def reduce_scatter_dp(self, tensor: torch.Tensor) -> torch.Tensor:
        """``(F, dp * rows, G)`` -> this rank's ``(F, rows, G)`` row block,
        summed over the dp group (int8 wraps mod 256)."""
        if not self.distributed:
            return tensor
        dp = self.shape["dp"]
        F, r_pad, g = tensor.shape
        rows = r_pad // dp
        # reduce_scatter_tensor splits dim 0: put the row blocks there
        blocks = tensor.view(F, dp, rows, g).transpose(0, 1).contiguous()
        out = torch.empty((F, rows, g), dtype=tensor.dtype,
                          device=tensor.device)
        dist.reduce_scatter_tensor(out.view(-1), blocks.view(-1),
                                   group=self.dp_group)
        return out

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """Stack every rank's ``tensor`` (one shape on all ranks):
        ``(world, *tensor.shape)``, in rank order."""
        if not self.distributed:
            return tensor[None]
        src = tensor.contiguous()
        out = torch.empty((self.world * src.numel(),), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out, src.view(-1))
        return out.view(self.world, *src.shape)

    def allgather_np(self, x: np.ndarray, device: torch.device,
                     pad_to: Optional[int] = None, fill=0) -> np.ndarray:
        """Every rank's 1-D ``x`` padded with ``fill`` to ``pad_to`` (default
        its own length; the ranks must agree), stacked: ``(world, pad_to)``
        (``_allgather_np`` of ``lime_tpu``).  Travels as bytes."""
        x = np.asarray(x)
        pad_to = len(x) if pad_to is None else pad_to
        padded = np.full(pad_to, fill, dtype=x.dtype)
        padded[:len(x)] = x
        t = torch.from_numpy(padded.view(np.uint8)).to(
            self.comm_device(device))
        out = self.all_gather(t).cpu().numpy()
        return out.view(x.dtype).reshape(self.world, pad_to)

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()


def default_shape(n: int) -> tuple:
    """``lime_tpu``'s default mesh shape for ``n`` devices: the largest
    factor up to sqrt(n) on dp, the rest on sp (the position stream is
    the long dimension)."""
    dp = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            dp = cand
            break
    return (n // dp, dp)


def make_mesh(n: Optional[int] = None,
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """The (sp, dp) mesh over every rank of the process group.

    ``n`` defaults to the world size (1 without a process group) and must
    equal it: a torch rank holds one device, so the mesh covers every
    rank.  The default shape is ``lime_tpu``'s (:func:`default_shape`); a
    shape whose product differs from the world size raises.  The groups
    are created here, on every rank in the same order (``new_group`` is
    collective): call it on every rank.
    """
    distributed = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    rank = dist.get_rank() if distributed else 0
    n = world if n is None else int(n)
    if n != world:
        raise ValueError(f"a mesh of {n} shards needs {n} ranks; the "
                         f"process group has {world}")
    sp, dp = default_shape(n) if shape is None else (int(v) for v in shape)
    if sp * dp != world:
        raise ValueError(f"mesh shape {sp}x{dp} does not cover the "
                         f"{world} ranks of the process group")
    mesh = Mesh({"sp": sp, "dp": dp}, rank, world)
    if distributed:
        for i in range(sp):
            g = dist.new_group([i * dp + j for j in range(dp)])
            if i == mesh.sp_i:
                mesh.dp_group = g
        for j in range(dp):
            g = dist.new_group([i * dp + j for i in range(sp)])
            if j == mesh.dp_j:
                mesh.sp_group = g
    return mesh
