"""Measured-best fused-chain configurations: the port of
``pystencils_autodiff_tpu/utils/autotune.py``.

The builders pick a chain's kernel by host reckonings (tiles, segments,
the z-streaming kernel's form by its work per owned cell), but the
fastest choice is a property of the card: PERF.md row 9 records the
reckoning keeping nl3d's bounded k=2 adjoint at 384³ f32 in the gather
form (4.416 ms) where the local form ran 3.712 ms.  ``autotune_chain`` /
``autotune_stage_chain`` sweep candidate configurations on the state's
device, time each, pick the fastest, and persist the winner in a JSON
cache — ``$PYSTENCILS_ADTPU_TUNE_CACHE``, else
``pystencils_adtpu_torch_tune.json`` under ``$XDG_CACHE_HOME`` or
``~/.cache``: a file of the port's own, so neither package serves the
other's records — keyed by op, shape, dtype, direction, the device
(``torch.cuda.get_device_name()``, or ``"cpu"``) and this module's timer
version, so a configuration is swept once per machine.

The sweep's axes are the chain depth ``k`` and the one per-shape variant
the port's builders take by name, the **form** of the fused adjoint
(``"gather"`` or ``"local"``; ``None`` leaves it to the reckoning): it
takes the place of the JAX API's tile axis (``tile_candidates``,
``tile_rows`` there; ``form_candidates``, ``"form"`` here), and
``tuned_tile`` keeps its name and returns the form.  It applies to
``adjoint_chain.fused_chain_vjp`` (the 3D two-phase route, the
z-streaming kernel; other routes raise on a form, and the sweep skips the
candidate) and ``stage_adjoint.fused_stage_chain_vjp`` (kernel 13,
through ``fused_stage_chain(fused_bwd=True, form=...)``).  Forward
builders take ``(None,)`` only; any other candidate raises.

Both adjoint builders consult the measured-best record when their
``form`` is None, before their reckoning (``best_config`` /
``tuned_tile``, logged as a cache hit), as the JAX package's builders
consult it for ``tile_rows``.

Kept from the JAX package: the sweep over ascending k with early stop
(past the per-step minimum), candidates ranked by a cheap timer and the
winner re-timed with the honest two-point slope timer before it is
cached, partial persistence (each measured candidate written at once; an
interrupted sweep resumes), failed candidates logged and skipped, and a
sweep in which every candidate fails raises.  The compile guard the JAX
sweep routed crashes through (``ops/guard.py``) is not ported: a
candidate that fails to build or launch is skipped like any other
failure.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

logger = logging.getLogger("pystencils_autodiff_tpu_torch.autotune")

__all__ = ["autotune_chain", "autotune_stage_chain", "TuneResult",
           "best_config", "tuned_tile", "stage_sig_of"]

# bumped whenever the measurement methodology changes incompatibly, so
# records taken under a superseded timer are never served (ttv1: the
# two-point slope of chained calls on the host clock, each run ended by a
# synchronise of the card)
_TIMER_VERSION = "ttv1"


def _device_name(device=None) -> str:
    """The record's device: the card's name for a CUDA device (default:
    the current card; raises where there is none), ``"cpu"`` for the
    CPU."""
    import torch

    from .benchmark import current_card

    device = current_card() if device is None else torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _canonical_key(kind: str, direction: str, sig: str, spatial, dtype,
                   periodic: bool, device: str) -> str:
    """Candidate-set-independent cache key: the measured-best record every
    later chain build consults.  Distinct from the sweep keys, which stay
    keyed by the candidate tuples so differently-scoped sweeps never
    alias; the device partitions the records (a CPU sweep never feeds a
    card's build, or the other way round)."""
    return (f"best|{kind}|{direction}|{sig}|"
            f"{tuple(int(n) for n in spatial)}|{_dtype_name(dtype)}|"
            f"periodic={periodic}|{device}|{_TIMER_VERSION}")


def stage_sig_of(stages, bcs) -> str:
    """Canonical signature of a stage sequence and its normalized in-chain
    BCs (``StagePlan.bcs``) — shared by ``autotune_stage_chain`` (store)
    and ``fused_stage_chain_vjp`` (consult)."""
    ss = "+".join(f"{op.op_name}{sorted(carry.items())}"
                  for op, carry in stages)
    bc_key = (repr(sorted((j, tuple(map(repr, bl)))
                          for j, bl in bcs.items())) if bcs else "None")
    return f"{ss}|bc={bc_key}"


def best_config(kind: str, direction: str, sig: str, spatial, dtype,
                periodic: bool, device=None):
    """The measured-best record for a chain configuration, or None:
    ``{"k": ..., "form": ..., "per_k": {str(k): {"form": ..., ...}}}`` —
    the overall winner plus the best form per swept depth.  ``device``: a
    ``torch.device`` or the record's device name (default: the current
    card; raises where there is none)."""
    if not isinstance(device, str):
        device = _device_name(device)
    return _load_cache().get(_canonical_key(kind, direction, sig, spatial,
                                            dtype, periodic, device))


def tuned_tile(kind: str, direction: str, sig: str, spatial, dtype,
               periodic: bool, k: int, device=None):
    """Measured-best form for a chain build at depth ``k`` (None where no
    sweep recorded one, or where the reckoning's pick won).  The adjoint
    builders consult this when the caller leaves ``form`` unset, so
    autotune winners reach the default route."""
    rec = best_config(kind, direction, sig, spatial, dtype, periodic,
                      device)
    if not rec:
        return None
    ent = rec.get("per_k", {}).get(str(int(k)))
    form = ent.get("form") if ent else None
    if form is not None:
        from .config import log_lowering_decision

        logger.info("autotune: measured-best form=%s for %s|%s k=%d at %s "
                    "(cache hit)", form, kind, sig, k, tuple(spatial))
        log_lowering_decision(sig, autotune="cache hit", kind=kind,
                              direction=direction, k=k,
                              spatial=tuple(spatial), form=form)
    return form


def _cache_path() -> str:
    p = os.environ.get("PYSTENCILS_ADTPU_TUNE_CACHE")
    if p:
        return p
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "pystencils_adtpu_torch_tune.json")


def _load_cache() -> dict:
    try:
        with open(_cache_path()) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def _save_cache(cache: dict) -> None:
    try:
        path = _cache_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(cache, fh, indent=1, sort_keys=True)
    except OSError as e:  # best effort: the sweep's result stands
        logger.warning("autotune: cache not written (%s)", e)


@dataclass
class TuneResult:
    """Outcome of an autotune sweep.

    ``best``: the winning ``{"k": ..., "form": ...}`` configuration.
    ``per_step_s``: its measured (or cached) per-step seconds.
    ``table``: ``{(k, form): per_step_s}`` for every candidate measured
    this call (empty on a cache hit).
    ``fn``: the chain callable built at the winning configuration.
    ``cached``: True when the winner was served from the persistent cache.
    """
    best: Dict[str, object]
    per_step_s: Optional[float]
    fn: Callable
    cached: bool
    table: Dict[Tuple[int, Optional[str]], float] = field(
        default_factory=dict)


def _chain_loop(chain_fn, state, vjp: bool):
    """``make(n)``: a callable running ``n`` data-dependent chain calls from
    a state; with ``vjp`` the value+gradient chain ``chain_fn(state, cots)
    -> (state_k, cot_0)``, its cotangents carried too — both chains live,
    as the JAX package's tv3 timers keep them."""
    import torch

    names = sorted(state)
    cots = ({n: torch.ones_like(state[n]) for n in names} if vjp else None)

    def make(nc):
        @torch.no_grad()
        def f(st):
            s = dict(st)
            if vjp:
                c = dict(cots)
                for _ in range(nc):
                    s, c0 = chain_fn(s, c)
                    c = {n: c0.get(n, c[n]) for n in names}
                return s[names[0]], c[names[0]]
            for _ in range(nc):
                s = chain_fn(s)
            return s[names[0]]
        return f

    return make


def _default_timer(chain_fn, state, k: int, calls: int, repeats: int,
                   vjp: bool) -> float:
    """Per-step seconds by the two-point slope over ``calls`` against
    ``2·calls`` chained chain calls (``benchmark.slope_timed``, raising on
    a noise-limited slope: a sweep must not rank on noise)."""
    from .benchmark import slope_timed

    t = slope_timed(_chain_loop(chain_fn, state, vjp), dict(state), calls,
                    2 * calls, repeats=repeats, on_noise="raise")
    return max(t / k, 1e-12)


def _cheap_timer(chain_fn, state, k: int, calls: int, repeats: int,
                 vjp: bool) -> float:
    """Candidate-ranking timer: per-step seconds of one run of ``calls``
    chained chain calls (one point, no slope).  Its constant per-run cost
    (the first launch, the final synchronise) is common to the candidates
    of one op and shape, so the ranking stands; the sweep re-times the
    winner with ``_default_timer`` before caching it.  (The JAX package's
    cheap timer saved a compile per candidate; in eager PyTorch it saves
    the second point.)"""
    from .benchmark import fetch_timed

    t = fetch_timed(_chain_loop(chain_fn, state, vjp)(calls), dict(state),
                    repeats=repeats)
    return max(t, 1e-9) / (k * calls)


def _check_forms(form_candidates, takes_forms: bool, what: str):
    if not takes_forms and any(f is not None for f in form_candidates):
        raise ValueError(f"{what}: the forward builders take no form; "
                         f"form_candidates must be (None,), got "
                         f"{tuple(form_candidates)}")


def autotune_chain(op, carry_map: Dict[str, str], state,
                   k_candidates: Sequence[int] = (2, 3, 4, 6, 8),
                   form_candidates: Sequence[Optional[str]] = (None,),
                   vjp: bool = False, periodic: bool = False,
                   calls: int = 4, repeats: int = 3,
                   timer: Optional[Callable] = None,
                   use_cache: bool = True, force: bool = False,
                   sweep: str = "fast",
                   **chain_kwargs) -> TuneResult:
    """Pick the fastest fused-chain configuration for ``op`` on the state's
    device and return it built, measured, and cached.

    ``state``: example state dict (tensors on the device to tune for) —
    fixes shapes and dtypes.  ``vjp=False`` tunes the forward chain
    (``ops.fused_time_chain``, ``form_candidates`` only ``(None,)``);
    ``vjp=True`` the fused value+gradient chain
    (``ops.adjoint_chain.fused_chain_vjp``, ``fn(state, cotangents)``),
    over ``form_candidates`` too.

    ``timer(chain_fn, state, k, calls, repeats, vjp) -> per_step_seconds``
    overrides the measurement (tests inject deterministic timers).
    ``force=True`` re-measures even on a cache hit.  Extra
    ``chain_kwargs`` go to the chain builder for every candidate (and keep
    the sweep from writing the record builds consult).

    ``sweep='fast'`` (default, with the default timer): early stop past
    the per-step minimum over ascending k, candidates ranked by
    ``_cheap_timer``, the winner re-timed; ``sweep='full'`` measures every
    candidate with the slope timer; an injected ``timer`` always sweeps
    fully.  Candidates that fail to build or run are skipped; if every
    candidate fails, the last error propagates."""
    from ..ops.adjoint_chain import fused_chain_vjp
    from ..ops.common import storage_spatial
    from ..ops.time_chain import fused_time_chain

    _check_forms(form_candidates, vjp, "autotune_chain(vjp=False)")
    names = sorted(state)
    arr0 = state[names[0]]
    spatial = tuple(arr0.shape)
    fby = {f.name: f for f in op.forward_input_fields}
    first = op.forward_input_fields[0]
    # the canonical record is keyed by the spatial shape and type of the
    # op's first state field, as the builders see them at a call
    can = state[first.name] if first.name in state else arr0
    can_spatial = storage_spatial(fby.get(first.name, first), can)
    device = _device_name(arr0.device)

    def build(k: int, form: Optional[str]):
        if vjp:
            return fused_chain_vjp(op, k, carry_map, periodic=periodic,
                                   form=form, **chain_kwargs)
        return fused_time_chain(op, k, carry_map, periodic=periodic,
                                **chain_kwargs)

    extra = ""
    if chain_kwargs:
        extra = "|" + ",".join(f"{k}={chain_kwargs[k]!r}"
                               for k in sorted(chain_kwargs))
    # candidate sets are part of the key: a winner picked from (2, 4)
    # must not be served to a caller sweeping (2, ..., 16), and builder
    # kwargs change what was measured
    direction = "vjp" if vjp else "fwd"
    key = (f"chain|{direction}|{op.op_name}|{spatial}|"
           f"{_dtype_name(arr0.dtype)}|periodic={periodic}|{device}"
           f"|k={tuple(k_candidates)}|forms={tuple(form_candidates)}"
           f"|{_TIMER_VERSION}" + extra)
    canonical = (None if chain_kwargs else _canonical_key(
        "chain", direction, op.op_name, can_spatial, can.dtype, periodic,
        device))
    fast = timer is None and sweep == "fast"
    return _run_sweep(build, key, state, k_candidates, form_candidates,
                      timer or _default_timer, vjp, calls, repeats,
                      use_cache, force, "autotune_chain",
                      canonical=canonical, early_stop=fast,
                      prune_timer=_cheap_timer if fast else None)


def _parse_form(s: str) -> Optional[str]:
    return None if s == "None" else s


def _run_sweep(build, key: str, state, k_candidates, form_candidates,
               timer, timer_flag: bool, calls: int, repeats: int,
               use_cache: bool, force: bool, what: str,
               canonical: Optional[str] = None,
               early_stop: bool = False,
               prune_timer: Optional[Callable] = None) -> TuneResult:
    """Shared sweep engine: cache-hit shortcut, (k, form) loop with
    skip-on-failure, winner selection, persistence.  ``canonical``: the
    candidate-set-independent key the builds consult (``best_config``);
    the sweep stores the winner plus the best form per depth there.

    * ``early_stop``: k-candidates are visited in the given (ascending)
      order; once a depth's best time is >10 % slower than the running
      best, deeper candidates are skipped (temporal blocking's cost is
      amortisation, then overlap: monotone past the minimum).
    * ``prune_timer``: a cheap ranking timer for the candidates; the
      winner alone is re-timed with ``timer`` before it is cached.
    * Partial persistence: every measured candidate is written to the
      cache (``key|partial``) at once, so an interrupted sweep resumes
      where it stopped; the final record replaces it."""
    cache = _load_cache() if use_cache else {}
    hit = cache.get(key)
    if hit and not force:
        k, form = hit["k"], hit.get("form")
        logger.info("autotune cache hit for %s: k=%d form=%s", key, k, form)
        return TuneResult(best={"k": k, "form": form},
                          per_step_s=hit.get("per_step_s"),
                          fn=build(k, form), cached=True)

    partial_key = key + "|partial"
    table: Dict[Tuple[int, Optional[str]], float] = {}
    fns: Dict[Tuple[int, Optional[str]], Callable] = {}
    if use_cache and not force:
        for ck, t in cache.get(partial_key, {}).items():
            k_s, form_s = ck.split(",", 1)
            table[(int(k_s), _parse_form(form_s))] = t
        if table:
            logger.info("autotune: resuming interrupted sweep for %s "
                        "(%d candidate(s) already measured)", key,
                        len(table))

    def save_partial():
        if use_cache:
            cache[partial_key] = {f"{k},{form}": t
                                  for (k, form), t in table.items()}
            _save_cache(cache)

    last_exc: Optional[BaseException] = None
    for k in k_candidates:
        k_best = float("inf")
        for form in form_candidates:
            if (k, form) in table:  # resumed from a partial sweep
                k_best = min(k_best, table[(k, form)])
                continue
            try:
                fn = build(k, form)
                t = (prune_timer or timer)(fn, state, k, calls, repeats,
                                           timer_flag)
            except Exception as e:  # a candidate that cannot run is skipped
                logger.warning("autotune: candidate k=%d form=%s failed "
                               "(%s: %s)", k, form, type(e).__name__,
                               str(e)[:120])
                last_exc = e
                continue
            table[(k, form)] = t
            fns[(k, form)] = fn
            k_best = min(k_best, t)
            save_partial()
            logger.info("autotune: k=%d form=%s -> %.3f ms/step",
                        k, form, t * 1e3)
        if early_stop and table and k_best < float("inf"):
            # a depth with no successful measurement must not count as a
            # slow strike (it would persist a truncated winner)
            run_best = min(table.values())
            if k_best > run_best * 1.10:
                logger.info("autotune: early stop after k=%d (%.3f ms/step "
                            "is >10%% over the running best %.3f) — "
                            "skipping deeper candidates", k, k_best * 1e3,
                            run_best * 1e3)
                break
    if not table:
        raise last_exc if last_exc is not None else RuntimeError(
            f"{what}: no viable candidates")

    (best_k, best_form), best_t = min(table.items(), key=lambda kv: kv[1])
    if prune_timer is not None:
        # the cached per_step_s comes from the honest slope timer
        try:
            win = fns.get((best_k, best_form)) or build(best_k, best_form)
            fns[(best_k, best_form)] = win
            best_t = timer(win, state, best_k, calls, repeats, timer_flag)
            table[(best_k, best_form)] = best_t
        except RuntimeError as e:
            logger.warning("autotune: winner re-time failed (%s); keeping "
                           "the ranking-timer value", str(e)[:120])
    if use_cache:
        cache.pop(partial_key, None)
        cache[key] = {"k": best_k, "form": best_form, "per_step_s": best_t}
        if canonical:
            per_k: Dict[str, dict] = {}
            for (k, form), t in table.items():
                cur = per_k.get(str(k))
                if cur is None or t < cur["per_step_s"]:
                    per_k[str(k)] = {"form": form, "per_step_s": t}
            cache[canonical] = {"k": best_k, "form": best_form,
                                "per_step_s": best_t, "per_k": per_k}
        _save_cache(cache)
    win = fns.get((best_k, best_form)) or build(best_k, best_form)
    return TuneResult(best={"k": best_k, "form": best_form},
                      per_step_s=best_t, fn=win, cached=False, table=table)


def _stage_timer(chain_fn, state, k: int, calls: int, repeats: int,
                 grad: bool) -> float:
    """Per-step seconds of stage-chain cycles by the two-point slope over
    ``calls`` against ``2·calls`` chained calls — value only, or
    value+gradient through autograd (kernel 13 when the chain was built
    with ``fused_bwd=True``), the cotangents carried from call to call."""
    import torch

    from .benchmark import slope_timed

    names = sorted(state)
    # only floating fields are carried: masks (bool/int) are
    # chain-invariant BC parameters and stay fixed; a dtype= override's
    # outputs are cast back to the state's types
    live = [n for n in names if state[n].is_floating_point()]
    fixed = {n: state[n] for n in names if n not in live}

    def make(nc):
        def f(st):
            s = {n: st[n] for n in live}
            ct = {n: torch.ones_like(st[n]) for n in live}
            for _ in range(nc):
                if grad:
                    with torch.enable_grad():
                        ins = {n: s[n].detach().requires_grad_()
                               for n in live}
                        out = chain_fn({**fixed, **ins})
                        gs = torch.autograd.grad(
                            [out[n] for n in live], [ins[n] for n in live],
                            [ct[n].to(out[n].dtype) for n in live],
                            allow_unused=True)
                    ct = {n: (g.detach().to(s[n].dtype) if g is not None
                              else ct[n]) for n, g in zip(live, gs)}
                    s = {n: out[n].detach().to(s[n].dtype) for n in live}
                else:
                    with torch.no_grad():
                        out = chain_fn({**fixed, **s})
                    s = {n: out[n].to(s[n].dtype) for n in live}
            return s[live[0]], ct[live[0]]
        return f

    t = slope_timed(make, dict(state), calls, 2 * calls, repeats=repeats,
                    on_noise="raise")
    return max(t / k, 1e-12)


def autotune_stage_chain(stages, state,
                         k_candidates: Sequence[int] = (2, 3, 4, 6, 8),
                         form_candidates: Sequence[Optional[str]] = (None,),
                         fused_bwd: bool = False, periodic: bool = False,
                         boundary=None, calls: int = 4, repeats: int = 3,
                         timer: Optional[Callable] = None,
                         use_cache: bool = True, force: bool = False,
                         sweep: str = "fast",
                         **chain_kwargs) -> TuneResult:
    """``autotune_chain`` for heterogeneous stage sequences
    (``ops.fused_stage_chain``): sweep (k, form) on the state's device and
    return the winning chain built and cached.

    ``stages``/``boundary`` follow ``fused_stage_chain``.  With
    ``fused_bwd=True`` each candidate is timed on its full value+gradient
    cost (kernel 12 and kernel 13 through autograd) and
    ``form_candidates`` are kernel 13's reverse forms; without it only
    ``(None,)``.  ``timer(chain_fn, state, k, calls, repeats, grad) ->
    per_step_seconds`` overrides the measurement."""
    from ..ops.common import storage_spatial
    from ..ops.stage_chain import StagePlan, fused_stage_chain

    _check_forms(form_candidates, fused_bwd,
                 "autotune_stage_chain(fused_bwd=False)")
    names = sorted(state)
    arr0 = state[names[0]]
    spatial = tuple(arr0.shape)
    device = _device_name(arr0.device)

    def build(k: int, form: Optional[str]):
        return fused_stage_chain(stages, k, periodic=periodic,
                                 fused_bwd=fused_bwd, boundary=boundary,
                                 form=form, **chain_kwargs)

    # the BCs normalized (StagePlan.bcs), so spellings that parse to the
    # same ChainBC list share one entry
    plan = StagePlan(stages, 1, periodic, boundary)
    sig = stage_sig_of(stages, plan.bcs)
    n0 = plan.state_names[0]
    can = state[n0] if n0 in state else arr0
    can_spatial = storage_spatial(plan.state_fields[n0], can)
    extra = ""
    if chain_kwargs:
        extra = "|" + ",".join(f"{k}={chain_kwargs[k]!r}"
                               for k in sorted(chain_kwargs))
    direction = "grad" if fused_bwd else "fwd"
    key = (f"stages|{direction}|{sig}|{spatial}|{_dtype_name(arr0.dtype)}|"
           f"periodic={periodic}|{device}|k={tuple(k_candidates)}|"
           f"forms={tuple(form_candidates)}|{_TIMER_VERSION}" + extra)
    canonical = (None if chain_kwargs else _canonical_key(
        "stages", direction, sig, can_spatial, can.dtype, periodic,
        device))
    return _run_sweep(build, key, state, k_candidates, form_candidates,
                      timer or _stage_timer, fused_bwd, calls, repeats,
                      use_cache, force, "autotune_stage_chain",
                      canonical=canonical,
                      early_stop=(timer is None and sweep == "fast"))
