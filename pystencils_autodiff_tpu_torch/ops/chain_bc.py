"""Boundary conditions inside fused stage chains: the port of
``pystencils_autodiff_tpu/ops/chain_bc.py``.

Each stage of a chain may be preceded by a list of BC events that
transform the tile state at the right (shrinking) extent, consuming their
own read reach from the halo exactly like a stencil stage.  Array-valued
BC parameters (obstacle masks, wall-velocity profiles, damping profiles)
are **state fields** named in the spec: they ride the chain as
pass-through planes, so a lid velocity differentiates like any state
field.  Scalar parameters are fixed when the chain is built.

Kinds (mirroring ``boundary.py``, the sequential implementation):
``dirichlet`` (frame, scalar value), ``neumann`` (frame copy of the first
interior cell), ``masked_dirichlet`` (mask field + scalar or field value),
``bounce_back`` (solid-mask field, optional moving-wall velocity
fields/scalars; out-of-domain pulls edge-clamp, as
``boundary.bounce_back(wrap=False)``), ``sponge`` (multiply by a damping
field or scalar; ``boundary.cerjan_damping`` builds the classic profile).

The device side of every kind, forward and transpose, is
``csrc/chain_bc.cuh``; ``apply_bc_sequential`` is the plain version the
CPU path and the tests run.  The JAX package also sizes halos in
flattened rows (``bc_row_reach``); the port's box tiles need only the
per-dim reach, ``bc_dim_reach``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..field import Field

__all__ = ["ChainBC", "normalize_chain_bcs", "bc_shift_offsets",
           "bc_dim_reach", "apply_bc_sequential", "apply_bc_shard",
           "POINTWISE_KINDS"]

# kinds whose output at a cell reads only that cell
POINTWISE_KINDS = ("dirichlet", "masked_dirichlet", "sponge")


@dataclasses.dataclass(frozen=True)
class ChainBC:
    field: str
    kind: str
    dims: Optional[Tuple[int, ...]] = None
    value: Union[float, str] = 0.0
    mask: Optional[str] = None
    u_wall: Optional[Tuple[Union[str, float], ...]] = None
    rho_wall: float = 1.0
    velocities: Optional[tuple] = None
    weights: Optional[tuple] = None
    opposite: Optional[tuple] = None


def _trailing(f: Field, arr: torch.Tensor) -> torch.Tensor:
    """``arr`` with its index dims trailing (AoS view of an 'soa' tensor)."""
    ni = f.index_dimensions
    if ni and getattr(f, "index_major", False):
        return torch.movedim(arr, tuple(range(ni)),
                             tuple(range(arr.dim() - ni, arr.dim())))
    return arr


def _restore(f: Field, arr: torch.Tensor) -> torch.Tensor:
    ni = f.index_dimensions
    if ni and getattr(f, "index_major", False):
        return torch.movedim(arr, tuple(range(arr.dim() - ni, arr.dim())),
                             tuple(range(ni)))
    return arr


def apply_bc_sequential(state, bc: ChainBC, ghost, periodic: bool,
                        fields=None):
    """Apply one ChainBC to a state dict of whole tensors with the plain
    implementations of ``boundary.py``: the plain version of the in-kernel
    BC events.  ``fields`` (``{name: Field}``) gives the target's storage
    layout (index dims of an 'soa' field lead; they are moved behind the
    spatial dims for the BC and back)."""
    from ..boundary import bounce_back, dirichlet, neumann

    f = (fields or {}).get(bc.field) or Field(bc.field, len(ghost))
    nd = len(ghost)
    arr = _trailing(f, state[bc.field])
    extra = (1,) * (arr.dim() - nd)

    def param(v):
        p = state[v] if isinstance(v, str) else torch.as_tensor(
            v, dtype=arr.dtype, device=arr.device)
        return p.reshape(tuple(p.shape) + extra) if p.dim() else p

    if bc.kind == "dirichlet":
        arr = dirichlet(arr, ghost, value=bc.value, dims=bc.dims)
    elif bc.kind == "neumann":
        arr = neumann(arr, ghost, dims=bc.dims)
    elif bc.kind == "masked_dirichlet":
        val = param(bc.value).to(arr.dtype)
        arr = torch.where(param(bc.mask) != 0, val, arr)
    elif bc.kind == "bounce_back":
        u_wall = (tuple(state[u] if isinstance(u, str) else u
                        for u in bc.u_wall)
                  if bc.u_wall is not None else None)
        arr = bounce_back(arr, state[bc.mask] != 0, u_wall=u_wall,
                          rho_wall=bc.rho_wall, velocities=bc.velocities,
                          weights=bc.weights, wrap=periodic)
    elif bc.kind == "sponge":
        arr = arr * param(bc.value)
    else:
        raise ValueError(bc.kind)
    return {**state, bc.field: _restore(f, arr)}


def _gather_dims(x: torch.Tensor, index) -> torch.Tensor:
    """``x[index_0[i0], index_1[i1], ...]`` over the leading dims, one
    per-dim index (None: the dim as it is)."""
    for d, idx in enumerate(index):
        if idx is not None:
            x = x.index_select(d, idx)
    return x


def apply_bc_shard(state, bc: ChainBC, ghost, periodic: bool, fields, shard,
                   bases):
    """``apply_bc_sequential`` on a halo-extended block of a sharded domain
    (``ops.flatten.ShardSpec``; ``shard`` None: the whole domain): frame
    cells, interior clamps and bounce-back edge clamps take the cell's
    global coordinate (block coordinate + ``bases``) against the global
    extents, as the kernels' BC events do (``csrc/chain_bc.cuh``); a read
    that leaves the block wraps in a dim a periodic domain keeps whole and
    repeats the block's edge elsewhere (the block's outer margin, which
    never reaches an owned cell)."""
    if shard is None or bc.kind in ("masked_dirichlet", "sponge"):
        return apply_bc_sequential(state, bc, ghost, periodic, fields)
    from .flatten import check_bases, shard_wraps

    nd = len(ghost)
    b = check_bases(shard, bases, nd)
    G = shard.global_spatial
    wraps = shard_wraps(periodic, nd, shard)
    f = (fields or {}).get(bc.field) or Field(bc.field, nd)
    arr = _trailing(f, state[bc.field])
    dev = arr.device
    spatial = arr.shape[:nd]
    coord = [torch.arange(n, device=dev) + b[d] for d, n in
             enumerate(spatial)]
    dims = bc.dims if bc.dims is not None else range(nd)

    def local(d, off):
        """block index of each cell's read at per-cell offsets ``off``"""
        i = torch.arange(spatial[d], device=dev) + off
        return i.remainder(spatial[d]) if wraps[d] else i.clamp(
            0, spatial[d] - 1)

    def bcast(v, d):
        return v.reshape([-1 if dd == d else 1 for dd in range(nd)]
                         + [1] * (arr.dim() - nd))

    if bc.kind == "dirichlet":
        frame = torch.zeros(spatial, dtype=torch.bool, device=dev)
        frame = frame.reshape(tuple(spatial) + (1,) * (arr.dim() - nd))
        for d in dims:
            lo, hi = ghost[d]
            if lo or hi:
                frame = frame | bcast((coord[d] < lo)
                                      | (coord[d] >= G[d] - hi), d)
        arr = torch.where(frame, torch.as_tensor(bc.value, dtype=arr.dtype,
                                                 device=dev), arr)
    elif bc.kind == "neumann":
        index = [None] * nd
        for d in dims:
            lo, hi = ghost[d]
            c = coord[d]
            t = c.clone()
            if lo:
                t = t.clamp(min=lo)
            if hi:
                t = t.clamp(max=G[d] - hi - 1)
            off = torch.where((c >= 0) & (c < G[d]), t - c,
                              torch.zeros_like(c))
            index[d] = local(d, off)
        arr = _gather_dims(arr, index)
    elif bc.kind == "bounce_back":
        solid = state[bc.mask] != 0
        comps = []
        for j, cj in enumerate(bc.velocities):
            index = [None] * nd
            for d, cd in enumerate(cj):
                if not cd:
                    continue
                c = coord[d]
                off = torch.full_like(c, int(cd))
                if not periodic:
                    inside = (c >= 0) & (c < G[d])
                    off = torch.where(inside,
                                      (c + cd).clamp(0, G[d] - 1) - c, off)
                index[d] = local(d, off)
            ghost_j = _gather_dims(arr[..., bc.opposite[j]], index)
            if bc.u_wall is not None and any(cj):
                cu = 0.0
                for cd, u in zip(cj, bc.u_wall):
                    if cd:
                        uw = state[u] if isinstance(u, str) else u
                        cu = cu + cd * uw
                w = bc.weights[j] if bc.weights else 0.0
                ghost_j = ghost_j + (6.0 * float(w) * bc.rho_wall) * cu
            comps.append(torch.where(solid, ghost_j, arr[..., j]))
        arr = torch.stack(comps, -1)
    else:
        raise ValueError(bc.kind)
    return {**state, bc.field: _restore(f, arr)}


def bc_shift_offsets(bc: ChainBC, nd: int) -> List[Tuple[int, ...]]:
    """Spatial offsets the BC reads at (reach accounting)."""
    if bc.kind in POINTWISE_KINDS:
        return []
    if bc.kind == "neumann":
        offs = []
        for d in (bc.dims if bc.dims is not None else range(nd)):
            for s in (1, -1):
                o = [0] * nd
                o[d] = s
                offs.append(tuple(o))
        return offs
    if bc.kind == "bounce_back":
        # the pull ghost_j(s) = f_jbar(s + c_j) READS at +c_j
        return [tuple(int(c) for c in v) for v in bc.velocities]
    raise ValueError(f"unknown chain BC kind {bc.kind!r}")


def bc_dim_reach(bc: ChainBC, ghost, nd: int) -> List[Tuple[int, int]]:
    """Per-spatial-dim (lo, hi) read reach of a BC event: the halo it
    consumes in the forward chain and, mirrored, in the adjoint's reverse
    sweep."""
    r = [(0, 0)] * nd
    if bc.kind in POINTWISE_KINDS:
        return r
    if bc.kind == "neumann":
        for d in (bc.dims if bc.dims is not None else range(nd)):
            g = max(ghost[d])
            r[d] = (g, g)
        return r
    if bc.kind == "bounce_back":
        # reads at +c_j: low reach = max(-c), high reach = max(c)
        for v in bc.velocities:
            for d, c in enumerate(v):
                lo, hi = r[d]
                r[d] = (max(lo, -c), max(hi, c))
        return r
    raise ValueError(bc.kind)


def _require_field_name(arg, what: str) -> Union[str, float]:
    """Array-valued BC args must be state-field *names* in fused chains."""
    if isinstance(arg, (str, int, float)):
        return arg
    raise TypeError(
        f"fused-chain BCs take {what} as a state-field NAME (the tensor is "
        f"then passed in the chain state and differentiates like any state "
        f"field), not an inline array — got {type(arg).__name__}")


def normalize_chain_bcs(boundary, state_fields: Dict[str, Field],
                        index_shapes: Dict[str, tuple], nd: int,
                        n_stages: int, dtype):
    """Parse the ``boundary`` argument of ``fused_stage_chain``.

    ``boundary``: ``{stage_idx: {field: spec}}`` or a plain ``{field:
    spec}`` dict (stage 0).  Specs follow ``boundary.BoundaryHandling``:
    a kind string, a ``(kind, *args)`` tuple, or a list thereof.

    Returns ``(bcs_per_stage, extra_fields)`` where extra_fields are
    scalar pass-through state fields the BCs reference (masks, wall
    profiles) that no stage reads.
    """
    if not boundary:
        return {}, {}
    if not all(isinstance(k, int) for k in boundary):
        boundary = {0: boundary}
    extra: Dict[str, Field] = {}

    def field_ref(name: str) -> str:
        if name not in state_fields and name not in extra:
            extra[name] = Field(name, nd, dtype=dtype)
        return name

    bcs: Dict[int, List[ChainBC]] = {}
    for stage_idx, specs in boundary.items():
        if not (0 <= stage_idx < n_stages):
            raise ValueError(f"boundary stage index {stage_idx} out of "
                             f"range for {n_stages} stages")
        out: List[ChainBC] = []
        for fname, spec in specs.items():
            if fname not in state_fields:
                raise ValueError(f"boundary field {fname!r} is not a chain "
                                 f"state field ({sorted(state_fields)})")
            chain_specs = spec if isinstance(spec, list) else [spec]
            for s in chain_specs:
                kind, args = (s, ()) if isinstance(s, str) else (s[0], s[1:])
                if kind == "dirichlet":
                    value = float(args[0]) if args else 0.0
                    dims = tuple(args[1]) if len(args) > 1 else None
                    out.append(ChainBC(fname, kind, dims=dims, value=value))
                elif kind == "neumann":
                    dims = tuple(args[0]) if args else None
                    out.append(ChainBC(fname, kind, dims=dims))
                elif kind == "masked_dirichlet":
                    mask = field_ref(_require_field_name(args[0], "the mask"))
                    value = args[1] if len(args) > 1 else 0.0
                    if isinstance(value, str):
                        value = field_ref(value)
                    else:
                        value = float(value)
                    out.append(ChainBC(fname, kind, mask=mask, value=value))
                elif kind == "sponge":
                    if not args:
                        raise ValueError("sponge needs a damping profile: "
                                         "('sponge', damp_field_or_scalar)")
                    damp = _require_field_name(args[0], "the damping "
                                               "profile")
                    if isinstance(damp, str):
                        damp = field_ref(damp)
                    else:
                        damp = float(damp)
                    out.append(ChainBC(fname, kind, value=damp))
                elif kind == "bounce_back":
                    out.append(_bounce_back_bc(fname, args, field_ref,
                                               index_shapes, nd))
                else:
                    raise ValueError(
                        f"BC kind {kind!r} cannot fuse into a chain; "
                        f"supported: dirichlet, neumann, masked_dirichlet, "
                        f"bounce_back, sponge")
        if out:
            bcs.setdefault(stage_idx, []).extend(out)
    return bcs, extra


def _bounce_back_bc(fname, args, field_ref, index_shapes, nd) -> ChainBC:
    mask = field_ref(_require_field_name(args[0], "the mask"))
    u_wall = None
    if len(args) > 1 and args[1] is not None:
        u_wall = tuple(
            field_ref(u) if isinstance(u, str) else float(u)
            for u in (_require_field_name(u, "a wall velocity")
                      for u in args[1]))
        if len(u_wall) != nd:
            raise ValueError(f"u_wall needs {nd} components")
    rho_wall = float(args[2]) if len(args) > 2 else 1.0
    ncomp = index_shapes.get(fname, ())
    if len(ncomp) != 1:
        raise ValueError(
            f"bounce_back target {fname!r} must be a 1-index-dim population "
            f"field, has index shape {ncomp}")
    velocities = args[3] if len(args) > 3 else None
    weights = args[4] if len(args) > 4 else None
    if velocities is None:
        from ..models.lbm import (D2Q9_VELOCITIES, D2Q9_WEIGHTS,
                                  D3Q19_VELOCITIES, D3Q19_WEIGHTS)

        if nd == 2 and ncomp[0] == 9:
            velocities, weights = D2Q9_VELOCITIES, D2Q9_WEIGHTS
        elif nd == 3 and ncomp[0] == 19:
            velocities, weights = D3Q19_VELOCITIES, D3Q19_WEIGHTS
        else:
            raise ValueError("bounce_back needs velocities= for this "
                             "field shape")
    velocities = tuple(tuple(int(c) for c in v) for v in velocities)
    if u_wall is not None and weights is None:
        raise ValueError("moving wall needs weights=")
    opposite = tuple(velocities.index(tuple(-c for c in v))
                     for v in velocities)
    return ChainBC(fname, "bounce_back", mask=mask, u_wall=u_wall,
                   rho_wall=rho_wall, velocities=velocities,
                   weights=(tuple(float(w) for w in weights)
                            if weights is not None else None),
                   opposite=opposite)
