"""Process group, sequence-parallel mesh, token slices and FSDP weights.

Port of ``jenga_tpu/parallel/mesh.py``: ``init_distributed`` takes the
place of ``jax.distributed.initialize`` (the reference's
``dist.init_process_group("nccl")``), ``make_sp_mesh`` builds a
``DeviceMesh`` instead of a ``jax.sharding.Mesh``, and
``shard_params_fsdp`` keeps JAX's layout but gathers a block's shards in a
forward pre-hook, where XLA inserts the all-gathers itself. The token
layout of the models (``shard_sizes``, ``shard_tokens``,
``gather_tokens``) is stated in the package docstring.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch import nn

from ..utils.logging import get_logger

__all__ = ["init_distributed", "make_sp_mesh", "make_multihost_sp_mesh",
           "shard_params_fsdp", "mesh_dims", "ulysses_fits",
           "warn_carving_disabled", "token_mesh", "shard_sizes",
           "token_range", "shard_tokens", "gather_tokens", "all_gather"]


def init_distributed(device="cuda", init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None) -> int:
    """Join the process group; returns the world size.

    The rank, world size and rendezvous come from the arguments, else from
    the launcher's environment (torchrun's ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``). A single process
    with no ``init_method`` is a no-op that returns 1; a second call
    returns the size of the group the first one made. The backend follows
    ``device``, never what the machine has: NCCL for a CUDA device, after
    ``torch.cuda.set_device`` of its index (``LOCAL_RANK`` when it has
    none), gloo for the CPU."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(world_size if world_size is not None
                else os.environ.get("WORLD_SIZE", 1))
    if world == 1 and init_method is None:
        return 1
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(index)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world,
        rank=int(rank if rank is not None else os.environ.get("RANK", 0)))
    return world


def make_sp_mesh(ring: int = 1, ulysses: int | None = None,
                 device="cuda"):
    """Sequence-parallel ``DeviceMesh`` over every rank of the group:
    dims ``("sp",)``, or with ``ring > 1`` ``("ring", "sp")``, the Ulysses
    axis innermost (neighbouring ranks carry the all-to-all; the ring
    rides the outer loop). ``world`` must equal ``ring x ulysses``
    (``ulysses`` defaults to ``world / ring``), the reference's
    composition contract."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    ring = max(1, int(ring))
    if ulysses is None:
        ulysses, shown = world // ring, f"{world / ring:.2f}"
    else:
        shown = str(ulysses)
    if ring * ulysses != world:
        raise ValueError(
            f"world ({world}) must equal ring ({ring}) x ulysses ({shown})"
            f" — the reference's composition contract "
            f"(hyvideo/config.py:451-468)")
    if not dist.is_initialized():
        raise RuntimeError("make_sp_mesh needs a process group: call "
                           "init_distributed first")
    dev = torch.device(device).type
    if ring == 1:
        return init_device_mesh(dev, (world,), mesh_dim_names=("sp",))
    return init_device_mesh(dev, (ring, ulysses),
                            mesh_dim_names=("ring", "sp"))


def make_multihost_sp_mesh(device="cuda", axis: str = "sp",
                           dcn_axis: str = "dp"):
    """``(dp, sp)`` mesh: sequence parallelism among the ranks of one host
    (``LOCAL_WORLD_SIZE`` of them, torchrun's count; all of them without
    it), data parallelism across hosts, so the all-to-alls never cross
    the slow links between hosts; the models copy their token slices
    over ``dp``. Needs ``init_distributed`` first."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"world ({world}) is not a multiple of the ranks "
                         f"per host ({local})")
    return init_device_mesh(torch.device(device).type,
                            (world // local, local),
                            mesh_dim_names=(dcn_axis, axis))


# ------------------------------------------------------------ token layout


def token_mesh(mesh, axes=("ring", "sp")):
    """The sub-mesh whose ranks share the token stream: the dims of
    ``mesh`` among ``axes`` (HunyuanVideo slices its image tokens over
    ``("ring", "sp")``, Wan over ``("sp",)`` alone, as JAX's models do).
    Every other dim (``dp``, or Wan's ``ring``) holds copies: its ranks
    run the same slices. ``mesh`` itself when it has no other dim."""
    names = tuple(n for n in mesh.mesh_dim_names if n in axes)
    return mesh if names == mesh.mesh_dim_names else mesh[names]


def mesh_dims(mesh):
    """(ring size, ring index, Ulysses size, Ulysses index) of this rank
    on a token mesh (``token_mesh``); a mesh without a ``ring`` dim has a
    ring of 1."""
    names = mesh.mesh_dim_names
    nu, u = mesh.shape[names.index("sp")], mesh.get_local_rank("sp")
    if "ring" not in names:
        return 1, 0, nu, u
    return mesh.shape[names.index("ring")], mesh.get_local_rank("ring"), \
        nu, u


def ulysses_fits(heads: int, mesh) -> bool:
    """Whether attention over ``heads`` heads runs under Ulysses, the one
    form that can carve (each rank needs the full sequence of whole
    heads): no ``ring`` axis, and heads the ``sp`` axis divides. Else the
    models run dense ring (x Ulysses) attention."""
    nr, _, nu, _ = mesh_dims(mesh)
    return nr == 1 and heads % nu == 0


def warn_carving_disabled(heads: int, mesh):
    """The JAX package's warning: carving silently lost is what a user of
    a ring mesh must be told (rank 0 logs it)."""
    nr, _, nu, _ = mesh_dims(mesh)
    get_logger("jenga_tpu_torch", rank=dist.get_rank()).warning(
        "carving DISABLED: heads_num=%d / mesh sp=%d ring=%d — joint "
        "attention degrades to dense ring attention and the carving "
        "speedup is lost. Use ring_degree=1 with an sp degree that "
        "divides the head count.", heads, nu, nr)


def shard_sizes(length: int, n: int) -> list[int]:
    """Token counts of ``n`` contiguous slices of ``length`` tokens:
    ``ceil(length / n)`` each, the last non-empty one shorter, any after it
    empty."""
    c = -(-length // n)
    return [max(0, min(c, length - i * c)) for i in range(n)]


def token_range(length: int, mesh) -> tuple[int, int]:
    """[start, stop) of this rank's slice of ``length`` tokens (slice
    ``ring_index * ulysses + ulysses_index``, ring-major)."""
    nr, r, nu, u = mesh_dims(mesh)
    n, i = nr * nu, r * nu + u
    start = min(i * -(-length // n), length)
    return start, start + shard_sizes(length, n)[i]


def shard_tokens(x, mesh, dim: int = 1):
    """This rank's slice of ``x`` along ``dim`` (a copy, so that the full
    tensor can be freed)."""
    start, stop = token_range(x.shape[dim], mesh)
    return x.narrow(dim, start, stop - start).clone()


def all_gather(out, x, group=None):
    """``out`` (the concatenation of every rank's ``x`` along dim 0) from
    ``x``: ``all_gather_single`` where torch has it, else its older name.
    1-byte floats (e4m3) travel as uint8."""
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    if x.element_size() == 1 and x.is_floating_point():
        out, x = out.view(torch.uint8), x.view(torch.uint8)
    gather(out, x.contiguous(), group=group)


def gather_tokens(x, mesh, length: int, dim: int = 1):
    """The whole ``length``-token tensor from every slice of it along
    ``dim`` on the token mesh: each slice padded to ``ceil(length / n)``,
    gathered over ``sp`` and then over ``ring`` (slice order is
    ring-major), the padding cut after."""
    nr, _, nu, _ = mesh_dims(mesh)
    c = -(-length // (nr * nu))
    xt = x.movedim(dim, 0)
    if xt.shape[0] < c:
        xt = torch.cat([xt, xt.new_zeros((c - xt.shape[0], *xt.shape[1:]))])
    for axis, n in (("sp", nu), ("ring", nr)):
        if n > 1:
            out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
            all_gather(out, xt, mesh.get_group(axis))
            xt = out
    return xt[:length].movedim(0, dim).contiguous()


# ------------------------------------------------------------------- FSDP


def _shard_dim(shape, n: int):
    """JAX's rule: the largest dimension ``n`` divides; of equal ones the
    last, which for a torch ``[out, in]`` linear weight is the first of
    JAX's ``[in, out]``. None when ``n`` divides none."""
    dims = sorted(range(len(shape)), key=lambda d: (-shape[d], -d))
    return next((d for d in dims if shape[d] % n == 0), None)


def _is_block(mod, parent) -> bool:
    return isinstance(parent, nn.ModuleList) and \
        type(mod).forward is not nn.Module.forward


class _Unit:
    """One module's sharded tensors: gathered before its forward, put back
    to the local shards after it."""

    def __init__(self, group, n: int):
        self.group, self.n = group, n
        self.shards = []        # (module, name, local shard, dim)

    @torch.no_grad()
    def gather(self, module, args):
        # the gathered weights are ordinary tensors even when the caller
        # runs under inference_mode, so that .data may hold them
        with torch.inference_mode(False):
            for mod, name, local, dim in self.shards:
                x = local.movedim(dim, 0).contiguous()
                out = x.new_empty((self.n * x.shape[0], *x.shape[1:]))
                all_gather(out, x, self.group)
                getattr(mod, name).data = out.movedim(0, dim).contiguous()

    def free(self, module, args, output):
        for mod, name, local, _ in self.shards:
            getattr(mod, name).data = local


@torch.no_grad()
def shard_params_fsdp(module: nn.Module, mesh, axis: str = "sp",
                      min_size: int = 2 ** 16) -> nn.Module:
    """Shard ``module``'s weights over the mesh axis in place (ZeRO-3):
    every parameter of at least ``min_size`` elements keeps only this
    rank's part along ``_shard_dim`` (fp8 ``w8`` included; its scalar
    ``scale``, norms, biases and modulation vectors stay whole), and JAX's
    ``shard_params_fsdp`` places each tensor the same way. Call it after
    the weights are loaded.

    A block (a member of an ``nn.ModuleList`` with its own ``forward``)
    all-gathers the shards of everything it holds in a forward pre-hook
    and drops them again in a forward hook; a sharded tensor outside every
    block is gathered around the forward of the module that owns it,
    which must therefore be called (``Affine.__call__``), not read."""
    n = mesh.shape[mesh.mesh_dim_names.index(axis)]
    if n == 1:
        return module
    group, me = mesh.get_group(axis), mesh.get_local_rank(axis)
    parents = {child: mod for mod in module.modules()
               for child in mod.children()}
    units = {}
    for name, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if p.numel() < min_size:
                continue
            dim = _shard_dim(p.shape, n)
            if dim is None:
                continue
            owner = mod
            while owner in parents and not _is_block(owner, parents[owner]):
                owner = parents[owner]
            if owner not in parents:     # reached the root: no block
                owner = mod
                if type(mod).forward is nn.Module.forward:
                    raise ValueError(
                        f"{name}.{pname} would be sharded but {name} has "
                        f"no forward to gather it in")
            size = p.shape[dim] // n
            local = p.data.narrow(dim, me * size, size).clone()
            p.data = local
            units.setdefault(owner, _Unit(group, n)).shards.append(
                (mod, pname, local, dim))
    for owner, unit in units.items():
        owner.register_forward_pre_hook(unit.gather)
        owner.register_forward_hook(unit.free)
    return module
