"""Ghost-layer boundary handling on torch tensors: the port of
``pystencils_autodiff_tpu/boundary.py``.

Every function is a frame write or an elementwise pass written with torch
slicing, ``torch.where`` and ``torch.roll``; none needs a kernel.  They are
out of place (the input tensor is never written), so autograd
differentiates through them: the adjoint of e.g. a Neumann fill, which
accumulates ghost gradients into the edge cells, comes out exactly.

Conventions match the stencil lowerings (``ops/common.py``): arrays carry
their ghost frame; a BC writes the frame, the stencil writes the interior.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .assignment import AssignmentCollection

__all__ = [
    "dirichlet",
    "neumann",
    "periodic",
    "masked_dirichlet",
    "masked_neumann",
    "bounce_back",
    "sponge",
    "cerjan_damping",
    "BoundaryHandling",
]

GhostSpec = Sequence[Tuple[int, int]]


def _frame_indices(ndim: int, dim: int, side: int, width: int, extent: int):
    idx = [slice(None)] * ndim
    idx[dim] = slice(0, width) if side == 0 else slice(extent - width, extent)
    return tuple(idx)


def _dim_slice(ndim: int, dim: int, start: int, stop: int):
    idx = [slice(None)] * ndim
    idx[dim] = slice(start, stop)
    return tuple(idx)


def dirichlet(arr: torch.Tensor, ghost: GhostSpec, value=0.0,
              dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Set the ghost frame to ``value`` (constant Dirichlet data)."""
    out = arr.clone()
    for d in (dims if dims is not None else range(len(ghost))):
        lo, hi = ghost[d]
        if lo:
            out[_frame_indices(arr.dim(), d, 0, lo, arr.shape[d])] = value
        if hi:
            out[_frame_indices(arr.dim(), d, 1, hi, arr.shape[d])] = value
    return out


def neumann(arr: torch.Tensor, ghost: GhostSpec,
            dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Zero-gradient BC: mirror the first interior cell into the ghost frame."""
    out = arr.clone()
    for d in (dims if dims is not None else range(len(ghost))):
        lo, hi = ghost[d]
        e = arr.shape[d]
        if lo:
            frame = _frame_indices(arr.dim(), d, 0, lo, e)
            edge = out[_dim_slice(arr.dim(), d, lo, lo + 1)].clone()
            out[frame] = edge.expand_as(out[frame])
        if hi:
            frame = _frame_indices(arr.dim(), d, 1, hi, e)
            edge = out[_dim_slice(arr.dim(), d, e - hi - 1, e - hi)].clone()
            out[frame] = edge.expand_as(out[frame])
    return out


def periodic(arr: torch.Tensor, ghost: GhostSpec,
             dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Wrap-around BC: ghost cells copy the opposite interior edge."""
    out = arr.clone()
    for d in (dims if dims is not None else range(len(ghost))):
        lo, hi = ghost[d]
        e = arr.shape[d]
        if lo:
            src = out[_dim_slice(arr.dim(), d, e - hi - lo, e - hi)].clone()
            out[_frame_indices(arr.dim(), d, 0, lo, e)] = src
        if hi:
            src = out[_dim_slice(arr.dim(), d, lo, lo + hi)].clone()
            out[_frame_indices(arr.dim(), d, 1, hi, e)] = src
    return out


# ---------------------------------------------------------------------------
# Flagged-cell (masked) boundary conditions: obstacles of arbitrary shape
# inside the domain, given as boolean masks over the spatial grid.


def _as_mask(mask, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(mask, device=like.device).to(torch.bool)


def _expand_mask(mask: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """Broadcast a spatial mask over trailing index dimensions of ``arr``."""
    if arr.dim() > mask.dim():
        return mask.reshape(tuple(mask.shape) + (1,) * (arr.dim() - mask.dim()))
    return mask


def _as_value(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def masked_dirichlet(arr: torch.Tensor, mask, value=0.0) -> torch.Tensor:
    """Flagged-cell Dirichlet: set ``arr`` to ``value`` wherever ``mask``.

    ``value`` may be a scalar or a tensor broadcastable to ``arr``; autograd
    zeroes cotangents inside the mask and routes them to a tensor ``value``.
    """
    mask = _expand_mask(_as_mask(mask, arr), arr)
    return torch.where(mask, _as_value(value, arr), arr)


def masked_neumann(arr: torch.Tensor, mask) -> torch.Tensor:
    """Flagged cells take the mean of their un-flagged face neighbours
    (zero normal gradient into the obstacle); cells with no fluid
    neighbour (obstacle interior) are set to 0.

    Neighbour gathering shifts do not wrap: contributions that would cross
    the domain edge are dropped, so border-touching masks stay local (use
    the frame BCs for true domain borders).
    """
    mask = _as_mask(mask, arr)
    nd = mask.dim()
    fluid = (~mask).to(arr.dtype)
    num = torch.zeros_like(arr)
    cnt = torch.zeros(mask.shape, dtype=arr.dtype, device=arr.device)

    def shift_nowrap(x, s, d):
        y = torch.roll(x, -s, dims=d)
        keep = torch.ones(x.shape[d], dtype=torch.bool, device=x.device)
        keep[slice(-s, None) if s > 0 else slice(0, -s)] = False
        shape = [1] * x.dim()
        shape[d] = x.shape[d]
        return torch.where(keep.reshape(shape), y, torch.zeros_like(y))

    for d in range(nd):
        for s in (-1, 1):
            nbr_fluid = shift_nowrap(fluid, s, d)
            nbr_val = shift_nowrap(arr * _expand_mask(fluid, arr), s, d)
            num = num + nbr_val * _expand_mask(nbr_fluid, arr)
            cnt = cnt + nbr_fluid
    filled = num / _expand_mask(torch.clamp(cnt, min=1), arr)
    return torch.where(_expand_mask(mask, arr), filled, arr)


def bounce_back(f: torch.Tensor, solid, u_wall=None, rho_wall: float = 1.0,
                velocities=None, weights=None, wrap: bool = False) -> torch.Tensor:
    """Half-way bounce-back (no-slip / moving wall) ghost-population
    preparation for pull-scheme LBM steps.

    Writes, into every flagged (solid) cell ``s``, the population a
    neighbouring fluid cell will pull on the next streaming step::

        f_j(s) = f_jbar(s + c_j) + 6 w_j rho_wall (c_j . u_wall)

    i.e. the population that left the fluid towards the wall comes back
    reversed, plus the Ladd moving-wall momentum term (c_s^2 = 1/3).
    Fluid cells pass through unchanged.  Differentiable: autograd reverses
    the copies and accumulates wall-velocity gradients.

    ``u_wall``: None (no-slip) or a tuple of per-axis wall velocities
    (scalars or spatial tensors).  ``velocities``/``weights`` default to
    the D2Q9 set.  Out-of-domain pulls read the edge-clamped value by
    default; pass ``wrap=True`` on periodic domains.
    """
    if velocities is None:
        from .models.lbm import D2Q9_VELOCITIES, D2Q9_WEIGHTS

        velocities = D2Q9_VELOCITIES
        if weights is None:
            weights = D2Q9_WEIGHTS
    elif weights is None and u_wall is not None:
        raise ValueError(
            "bounce_back: a moving wall (u_wall) with a custom velocity set "
            "needs the matching lattice weights — pass weights= (the Ladd "
            "momentum term is 6 w_j rho (c_j . u_wall))")
    velocities = [tuple(int(c) for c in v) for v in velocities]
    opposite = [velocities.index(tuple(-c for c in v)) for v in velocities]
    solid = _as_mask(solid, f)
    nd = solid.dim()
    if f.dim() != nd + 1 or f.shape[-1] != len(velocities):
        raise ValueError(
            f"f must be spatial+({len(velocities)},) for this velocity set; "
            f"got {tuple(f.shape)} with {nd}-D mask")
    if u_wall is not None:
        u_wall = tuple(_as_value(u, f) for u in u_wall)
        if len(u_wall) != nd:
            raise ValueError(f"u_wall needs {nd} components, got {len(u_wall)}")

    def shift_clamped(x, shifts):
        y = torch.roll(x, shifts, dims=tuple(range(nd)))
        if wrap:
            return y
        for d, s in enumerate(shifts):
            if not s:
                continue
            # overwrite the wrapped rows with the edge value (clamp)
            n = x.shape[d]
            if s > 0:  # rolled forward: first s rows wrapped from the end
                rows, edge = slice(0, s), slice(s, s + 1)
            else:
                rows, edge = slice(n + s, n), slice(n + s - 1, n + s)
            y = y.clone()
            fill = y[_dim_slice(x.dim(), d, edge.start, edge.stop)].clone()
            y[_dim_slice(x.dim(), d, rows.start, rows.stop)] = \
                fill.expand_as(y[_dim_slice(x.dim(), d, rows.start, rows.stop)])
        return y

    comps = []
    for j, cj in enumerate(velocities):
        ghost = shift_clamped(f[..., opposite[j]], tuple(-c for c in cj))
        if u_wall is not None and any(cj):
            cu = sum((c * u for c, u in zip(cj, u_wall) if c),
                     torch.zeros((), dtype=f.dtype, device=f.device))
            ghost = ghost + (6.0 * float(weights[j]) * rho_wall) * cu
        comps.append(torch.where(solid, ghost, f[..., j]))
    return torch.stack(comps, -1)


def sponge(arr: torch.Tensor, damp) -> torch.Tensor:
    """Absorbing-layer (Cerjan/sponge) damping: multiply by a profile.

    ``damp`` is a spatial tensor (build one with :func:`cerjan_damping`) or
    a scalar; interior cells carry 1.0 and the absorbing frame decays
    towards the boundary.  Diagonal-linear in ``arr``, so the adjoint is
    the same multiply on the cotangent; a ``damp`` that requires grad gets
    ``arr * ĉ``.  Index dimensions of ``arr`` are trailing.
    """
    damp = _as_value(damp, arr)
    if damp.dim() and arr.dim() > damp.dim():
        damp = damp.reshape(tuple(damp.shape) + (1,) * (arr.dim() - damp.dim()))
    return arr * damp


def cerjan_damping(shape: Sequence[int], width: int, alpha: float = 0.0053,
                   dims: Optional[Sequence[int]] = None,
                   free: Sequence[Tuple[int, int]] = (),
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Cerjan et al. (1985) absorbing-layer profile for :func:`sponge`.

    ``G(i) = exp(-(alpha * (width - i))^2)`` for cells ``i < width`` from
    a boundary, 1 in the interior; per-dim factors multiply, so corners
    damp with the product.  ``free`` lists ``(dim, side)`` pairs to leave
    undamped (e.g. ``[(0, 0)]`` keeps a free surface at the top in FWI).
    The profile is built on ``device``, the card unless the caller names
    another (``device="cpu"``), as every entry point of the port runs.
    """
    nd = len(shape)
    free = {(int(d), int(s)) for d, s in free}
    damp = np.ones(tuple(shape), np.float64)
    for d in (dims if dims is not None else range(nd)):
        n = int(shape[d])
        idx = np.arange(n)
        g = np.ones(n, np.float64)
        for side in (0, 1):
            if (d, side) in free:
                continue
            dist = idx if side == 0 else (n - 1 - idx)
            g = g * np.where(dist < width,
                             np.exp(-(alpha * (width - dist)) ** 2), 1.0)
        damp = damp * g.reshape([n if dd == d else 1 for dd in range(nd)])
    return torch.tensor(damp, dtype=dtype,
                        device="cuda" if device is None else device)


_BC_FNS = {"dirichlet": dirichlet, "neumann": neumann, "periodic": periodic}
# masked BCs take (arr, *args) — no ghost-frame spec
_MASKED_BC_FNS = {"masked_dirichlet": masked_dirichlet,
                  "masked_neumann": masked_neumann,
                  "bounce_back": bounce_back,
                  "sponge": sponge}


class BoundaryHandling:
    """Per-field boundary conditions applied before a stencil step.

    Specify a BC per field; call the instance on a state dict to get
    BC-applied tensors.  Frame BCs take the ghost spec implicitly; masked
    (flagged-cell) BCs take their mask (and further args) in the spec
    tuple::

        bh = BoundaryHandling(op, {"u": "neumann", "p": ("dirichlet", 0.0)})
        bh = BoundaryHandling(op, {"f": ("bounce_back", solid, (u_lid, 0.0))})
        state = bh(state)

    A spec may also be a *list* of specs applied in order, and its last
    element may be a dict of keyword arguments for the BC function, e.g.
    ``("bounce_back", solid, {"wrap": True})``.
    """

    def __init__(self, op_or_ghost, specs: Dict[str, Union[str, tuple, list]]):
        if hasattr(op_or_ghost, "forward_assignments"):
            coll = AssignmentCollection.normalize(op_or_ghost.forward_assignments)
            self.ghost = coll.ghost_layers()
        else:
            self.ghost = tuple(op_or_ghost)
        self.specs = {}
        for name, spec in specs.items():
            chain = spec if isinstance(spec, list) else [spec]
            parsed = []
            for s in chain:
                if isinstance(s, str):
                    kind, args = s, ()
                else:
                    kind, *args = s
                if kind not in _BC_FNS and kind not in _MASKED_BC_FNS:
                    raise ValueError(f"unknown BC {kind!r}; have "
                                     f"{sorted(_BC_FNS) + sorted(_MASKED_BC_FNS)}")
                kwargs = {}
                if args and isinstance(args[-1], dict):
                    kwargs = dict(args[-1])  # snapshot: no caller aliasing
                    args = args[:-1]
                parsed.append((kind, tuple(args), kwargs))
            self.specs[name] = parsed

    def apply(self, name: str, arr: torch.Tensor) -> torch.Tensor:
        for kind, args, kwargs in self.specs.get(name, ()):
            if kind in _MASKED_BC_FNS:
                arr = _MASKED_BC_FNS[kind](arr, *args, **kwargs)
            else:
                arr = _BC_FNS[kind](arr, self.ghost, *args, **kwargs)
        return arr

    def __call__(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {name: self.apply(name, arr) for name, arr in state.items()}
