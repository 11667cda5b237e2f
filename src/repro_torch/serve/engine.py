"""Serving engines: the LM ``Scheduler`` and the batched FIR filterbank.

Counterpart of ``repro.serve.engine``.

``make_serve_fns`` gives the LM's two entry points as plain closures
(PyTorch runs eagerly: there is no ``jit`` to carry over), with the
bitexact datapath's weight precode (``lm_amm_planes``) baked in:

  prefill(params, tokens, caches[, encoder_embeds])       -> (logits, caches)
  decode(params, tokens_1, caches, pos[, encoder_embeds]) -> (logits, caches)

An encoder-decoder model (whisper-base) is served through them alone,
with its frame embeddings passed to every call, prefill and decode: the
reference's ``Scheduler`` passes none and cannot serve it, so the port's
refuses it.

With ``kv_codes=True`` the caches are the int-code KV cache
(``serve.kv_cache``): wl-bit codes frozen at write time plus per-block
f32 scales, decoded straight from the codes, so every request's token
stream and cache bits are those of its solo run under ``apply_to="attn"``.

``Scheduler`` serves LM requests from a fixed pool of batch slots, in the
reference's flush mode (lockstep, one prompt token per step) or its
continuous mode (per-step FIFO admission, whole-prompt prefill on a
batch-1 slot slice, per-slot-position decode, eviction on completion or
failure), with its retries, poison-request probes, deadlines and guards.
The caches live on the scheduler's device; the attention leaves are
updated in place (the reference replaces them with each call's result),
the SSM and hybrid families' ``ssm`` and ``conv`` leaves come back as new
tensors, and the scheduler rebinds the caches to each call's result.  A
prefill's state written back into a slot takes the cache leaf's dtype
(a bf16 ``conv`` leaf until the first decode returns it f32, as in the
reference; ROADMAP C12).

``FilterbankEngine`` serves the paper's own workload: filtering requests
accumulate into channel slots and are served by one multi-channel
Broken-Booth filterbank dispatch per flush (``dsp.fir_apply``).  The tap
banks are fixed for the engine's lifetime, so their quantization and
Booth recode happen once, at construction (``dsp.PrecodedBank``), and
every flush gathers the cached digit planes by request index.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.guards import GuardConfig, finite_rows, guard_rows
from ..core.multipliers import MulSpec
from ..device import pin_fp32, resolve_device
from ..dsp.fir import BBM_KINDS, PrecodedBank, fir_apply
from ..kernels.booth_rows import resolve_form
from ..models import (AmmRuntime, ModelRuntime, init_cache, lm_amm_planes,
                      lm_apply)
from .kv_cache import (KV_BLOCK, batch_axis_tree, code_cache_logical_axes,
                       init_code_cache, reset_slot, slot_put, slot_take)

__all__ = ["cache_logical_axes", "make_serve_fns", "Request", "Scheduler",
           "FilterRequest", "FilterbankEngine"]


def cache_logical_axes(cfg: ArchConfig, *,
                       kv_codes: bool = False) -> Dict[str, Any]:
    """Logical axes of every cache leaf of ``models.init_cache`` (the
    dense family's k and v; the MoE family's MLA latent, or its k and v
    without MLA; the SSM family's scan state and conv history; the
    hybrid's, under a group axis that puts the batch at depth 2, beside
    its k and v; the encoder-decoder family's k, v, xk and xv), or with
    ``kv_codes=True`` of ``serve.kv_cache.init_code_cache``."""
    if kv_codes:
        return code_cache_logical_axes(cfg)
    if cfg.family == "ssm":
        return {"ssm": ("layers", "batch", "ssm_heads", "head_dim",
                        "ssm_state"),
                "conv": ("layers", "batch", "conv", "ssm_inner")}
    if cfg.family == "hybrid":
        kvax = ("layers", "batch", "seq", "kv_heads", "head_dim")
        return {"ssm": ("layers", None, "batch", "ssm_heads", "head_dim",
                        "ssm_state"),
                "conv": ("layers", None, "batch", "conv", "ssm_inner"),
                "k": kvax, "v": kvax}
    if cfg.use_mla:
        return {"latent": ("layers", "batch", "seq_model", "kv_latent")}
    kvax = ("layers", "batch", "seq", "kv_heads", "head_dim")
    if cfg.is_encoder_decoder:
        return {"k": kvax, "v": kvax, "xk": kvax, "xv": kvax}
    return {"k": kvax, "v": kvax}


def make_serve_fns(cfg: ArchConfig, rt: ModelRuntime, *, amm_planes=None,
                   kv_codes: bool = False):
    """(prefill_fn, decode_fn): ``lm_apply`` in decode mode against the
    caches, each returning the last position's logits.  Prefill writes
    the prompt at position 0; decode takes a scalar position or a (B,)
    per-slot vector.  Both run on the device the parameters live on.

    amm_planes: an optional ``lm_amm_planes`` cache the closures carry
    (serving weights are fixed: the bitexact weight precode happens once,
    not in every step).  kv_codes: the functions serve the int-code cache
    (checked here: it needs an active Booth-family bitexact attention
    lowering on ``rt``; the cache itself is the caller's).
    ``encoder_embeds``: the frame embeddings (B, encoder_len, d_model) an
    encoder-decoder model needs in every call, as in the reference."""
    if kv_codes and rt.amm.attn_lowering is None:
        raise ValueError("kv_codes serving requires an active Booth-family "
                         "bitexact amm attention lowering")

    def prefill(params, tokens, caches, encoder_embeds=None):
        logits, _, new_caches = lm_apply(params, cfg, rt, tokens,
                                         mode="decode", caches=caches, pos=0,
                                         encoder_embeds=encoder_embeds,
                                         amm_planes=amm_planes)
        return logits[:, -1], new_caches

    def decode(params, tokens, caches, pos, encoder_embeds=None):
        logits, _, new_caches = lm_apply(params, cfg, rt, tokens,
                                         mode="decode", caches=caches,
                                         pos=pos,
                                         encoder_embeds=encoder_embeds,
                                         amm_planes=amm_planes)
        return logits[:, -1], new_caches

    return prefill, decode


@dataclasses.dataclass
class FilterRequest:
    rid: int
    signal: np.ndarray            # 1-D real samples
    bank: int = 0                 # which tap bank filters this request


class FilterbankEngine:
    """Batched FIR serving: N pending requests -> one filterbank dispatch.

    Each request names the tap bank that filters it.  ``flush`` pads the
    pending signals to a common length, stacks them into a (C, N) batch,
    gathers the per-request banks out of the precoded cache, runs the
    batch through ``dsp.fir_apply`` in one call on ``device`` (None: the
    GPU, where the filterbank kernels are built here, before any request,
    so a kernel that cannot build fails construction instead of being
    quarantined request by request), and returns each request's output
    trimmed to its own length.
    """

    def __init__(self, h_banks: np.ndarray, spec: MulSpec, *,
                 backend: str = "host", max_channels: int = 64,
                 form: Optional[str] = None,
                 guard: Optional[GuardConfig] = None, max_retries: int = 1,
                 device=None):
        h_banks = np.atleast_2d(np.asarray(h_banks, np.float64))
        self.device = resolve_device(device)
        self.h_banks = h_banks
        self.spec = spec
        if backend not in ("host", "cuda"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.max_channels = max_channels
        resolve_form(form)    # fail fast: flush() dequeues before it serves
        if form == "dot" and (spec.name not in BBM_KINDS or spec.wl > 16):
            # reject at construction what every flush would reject
            raise ValueError(f"form='dot' needs a Booth-family spec at "
                             f"wl <= 16, not {spec}")
        self.form = form          # "rows" | "dot" | None (auto)
        self.guard = guard
        self.max_retries = max_retries
        self._apply = fir_apply
        if self.device.type == "cuda":
            from ..kernels._build import library
            library("fir_bank")
        self.bank = PrecodedBank(h_banks, spec, device=self.device)
        self._pending: List[FilterRequest] = []
        self._next_rid = 0
        self._dispatches = 0      # audit cadence counter (guard.budget_every)
        # requests the degradation path gave up on: {rid: repr(error)}
        self.failed: Dict[int, str] = {}
        self.stats = {"dispatches": 0, "served": 0, "retries": 0,
                      "bisections": 0, "quarantined": 0, "guard_trips": 0,
                      "exact_reserves": 0}

    def submit(self, signal: np.ndarray, bank: int = 0) -> int:
        """Queue one signal; returns its request id."""
        if not 0 <= bank < len(self.h_banks):
            raise ValueError(f"unknown tap bank {bank}")
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(FilterRequest(rid, np.asarray(signal), bank))
        return rid

    def flush(self) -> Dict[int, np.ndarray]:
        """Serve every pending request; returns {rid: filtered signal}.

        A raising dispatch is retried up to ``max_retries`` times; a batch
        that still fails is bisected until the poison request is alone
        and quarantined into ``self.failed``, while every healthy request
        of the batch is served.  The queue is dequeued before serving, so
        a poison request cannot wedge later flushes.  With ``guard`` set,
        tripped channels are re-served on the exact datapath.
        """
        results: Dict[int, np.ndarray] = {}
        while self._pending:
            batch = self._pending[: self.max_channels]
            self._pending = self._pending[self.max_channels:]
            self._serve(batch, results)
        return results

    def _stack(self, batch: List[FilterRequest]) -> np.ndarray:
        n = max(len(r.signal) for r in batch)
        x = np.zeros((len(batch), n))
        for c, r in enumerate(batch):
            x[c, : len(r.signal)] = r.signal
        return x

    def _dispatch(self, batch: List[FilterRequest]) -> np.ndarray:
        """One filterbank call with bounded retry; raises when exhausted."""
        x = self._stack(batch)
        h = self.bank.take([r.bank for r in batch])
        for attempt in range(self.max_retries + 1):
            self.stats["dispatches"] += 1
            self._dispatches += 1
            try:
                return np.asarray(self._apply(
                    x, h, self.spec, backend=self.backend, form=self.form,
                    device=self.device))
            except Exception:
                if attempt == self.max_retries:
                    raise
                self.stats["retries"] += 1

    def _serve(self, batch: List[FilterRequest],
               results: Dict[int, np.ndarray]):
        """Serve one batch with bisection quarantine + runtime guards."""
        try:
            y = self._dispatch(batch)
        except Exception as e:
            if len(batch) == 1:
                self.failed[batch[0].rid] = repr(e)
                self.stats["quarantined"] += 1
                return
            self.stats["bisections"] += 1
            mid = len(batch) // 2
            self._serve(batch[:mid], results)
            self._serve(batch[mid:], results)
            return
        bad = self._guard_channels(batch, y)
        for c, r in enumerate(batch):
            if c in bad:
                results[r.rid] = self._reserve_exact(r)
            else:
                results[r.rid] = y[c, : len(r.signal)]
            self.stats["served"] += 1

    def _guard_channels(self, batch: List[FilterRequest],
                        y: np.ndarray) -> set:
        """Indices of channels whose runtime guards tripped this dispatch."""
        if self.guard is None:
            return set()
        y_exact = None
        if self.guard.budget_active \
                and self._dispatches % self.guard.budget_every == 0:
            # sampled accuracy audit: the same batch on the exact datapath
            y_exact = self._exact_batch(batch)
        rep = guard_rows(y, self.guard, y_exact=y_exact)
        if rep.ok:
            return set()
        bad = {c for c in range(len(batch)) if not rep.row_ok[c]}
        self.stats["guard_trips"] += len(bad)
        return bad

    def _exact_spec(self) -> MulSpec:
        """Exact-Booth comparand at this engine's word length."""
        return MulSpec("booth", self.spec.wl, 0)

    def _exact_batch(self, batch: List[FilterRequest]) -> np.ndarray:
        x = self._stack(batch)
        h = self.h_banks[[r.bank for r in batch]]
        return np.asarray(self._apply(x, h, self._exact_spec(),
                                      backend="host", form=None,
                                      device=self.device))

    def _reserve_exact(self, r: FilterRequest) -> np.ndarray:
        """Serve one guard-tripped request on the exact datapath."""
        self.stats["exact_reserves"] += 1
        y = self._apply(r.signal[None, :], self.h_banks[[r.bank]],
                        self._exact_spec(), backend="host", form=None,
                        device=self.device)
        return np.asarray(y)[0]


# ------------------------------------------------------------ LM serving
@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # degradation-path fields: why the request failed (None = healthy),
    # an optional per-request deadline in scheduler steps, whether the
    # output was re-served on the exact datapath after a guard trip
    error: Optional[str] = None
    deadline: Optional[int] = None
    exact: bool = False
    _pending: List[int] = dataclasses.field(default_factory=list)
    _steps: int = 0


def _argmax_rows(logits: torch.Tensor) -> np.ndarray:
    return torch.argmax(logits, dim=-1).cpu().numpy().reshape(-1)


class Scheduler:
    """Slot-based LM batch scheduler over the decode step.

    The reference's two modes, its degradation policy and its ``stats``,
    step for step:

      * ``continuous=False`` (flush mode): admission only into an idle
        batch, prompts fed one token per step through the batched decode,
        every resident walking in lockstep;
      * ``continuous=True``: FIFO admission into free slots, at most
        ``max_prefills_per_step`` per step, the prompt prefilled as one
        batch-1 dispatch on the slot's cache slice, then one decode over
        all residents at their own positions; slots are evicted (and
        zeroed on the next admission) on completion or failure.

    Degradation (all opt-in): a raising decode step is retried
    ``max_retries`` times with capped exponential backoff; then each live
    slot is probed alone against a copy of the caches and the requests
    the failure follows fail alone (a failure no probe reproduces
    re-raises); ``guard`` runs per-slot guards on each step's logits and
    re-serves a tripped request from scratch on the exact datapath;
    ``Request.deadline`` bounds the steps a request may hold a slot.

    ``kv_codes=True`` stores the KV cache as wl-bit int codes plus one f32
    scale per ``kv_block`` positions and kv head (``serve.kv_cache``;
    needs an active Booth-family bitexact attention lowering, and no
    guard budget audit, whose exact replay cannot read codes): decode
    feeds the frozen codes straight into the datapath.  Without a
    ``decode_fn`` the scheduler precodes the bitexact weights once
    (``self.amm_planes``) for its own step functions.

    ``device``: where the caches live and the steps run (the GPU unless
    told otherwise); ``params`` must already be there.  An
    encoder-decoder config raises ``ValueError``: its calls need frame
    embeddings, which the reference's scheduler never passes (serve it
    through ``make_serve_fns``).  The default step
    functions update the attention caches in place; a retry rewrites the
    same positions from the same inputs (the SSM state is returned anew,
    so a failed step leaves it as it was).  A supplied ``decode_fn`` counts as
    consuming its caches, as a donating jitted step does in the
    reference: retries then snapshot the caches first.
    """

    def __init__(self, cfg: ArchConfig, rt: ModelRuntime, params,
                 batch_slots: int, max_len: int, decode_fn=None, *,
                 prefill_fn=None, continuous: bool = False,
                 kv_codes: bool = False, kv_block: int = KV_BLOCK,
                 max_prefills_per_step: int = 1,
                 guard: Optional[GuardConfig] = None, max_retries: int = 0,
                 backoff: float = 0.0, backoff_cap: float = 1.0,
                 device=None):
        if cfg.is_encoder_decoder:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder model: every call needs "
                f"its frame embeddings, which the Scheduler does not pass "
                f"(the reference's cannot serve it either); serve it "
                f"through make_serve_fns' prefill and decode with "
                f"encoder_embeds")
        if kv_codes:
            if not rt.amm.attn_active or rt.amm.attn_lowering is None:
                raise ValueError(
                    "kv_codes stores the cache as Broken-Booth int codes; "
                    "it requires an active Booth-family bitexact amm "
                    "attention lowering (AmmConfig mode='bitexact', "
                    "Booth-family mul, apply_to 'attn'/'all')")
            if guard is not None and guard.budget_active:
                raise ValueError(
                    "the guard budget audit replays the step on the exact "
                    "datapath, which cannot read an int-code cache — use "
                    "finite-only guards or kv_codes=False")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"parameters on {params['embed'].device}, "
                             f"scheduler on {self.device}")
        pin_fp32()
        self.cfg, self.rt, self.params = cfg, rt, params
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.pos = np.zeros(batch_slots, np.int32)
        self.max_len = max_len
        if kv_codes:
            self.caches = init_code_cache(
                cfg, batch_slots, max_len, wl=rt.amm.attn_lowering[0],
                block=kv_block, device=self.device)
        else:
            self.caches = init_cache(cfg, batch_slots, max_len,
                                     device=self.device)
        self.continuous = continuous
        self.kv_codes = kv_codes
        self.max_prefills_per_step = max_prefills_per_step
        self._bax = batch_axis_tree(cache_logical_axes(cfg,
                                                       kv_codes=kv_codes))
        self.queue: List[Request] = []
        self.decode_fn = decode_fn
        self.prefill_fn = prefill_fn
        self.guard = guard
        self.max_retries = max_retries
        self.backoff = backoff
        self.backoff_cap = backoff_cap
        self.stats = {"steps": 0, "decoded": 0, "completed": 0,
                      "prefills": 0, "retries": 0, "probes": 0,
                      "failed": 0, "guard_trips": 0, "exact_reserves": 0,
                      "deadline_expired": 0}
        # a supplied decode_fn carries its own planes (launch.serve builds
        # them once): only the default step functions need them here
        self.amm_planes = (lm_amm_planes(cfg, rt.amm, params)
                           if decode_fn is None else None)
        self._prefill_default, self._default_fn = make_serve_fns(
            cfg, rt, amm_planes=self.amm_planes, kv_codes=kv_codes)

    def submit(self, req: Request):
        """Queue one request; invalid specs raise here, not mid-serve.

        A prompt of ``max_len`` or more tokens can never produce a token,
        so it is rejected; an empty prompt decodes from token 0.
        """
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be >= 1, "
                             f"got {req.max_new}")
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                f"cannot fit max_len={self.max_len} (needs at least one "
                f"free position to decode)")
        self.queue.append(req)

    def _admit(self):
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                self.pos[i] = 0
                req._pending = list(req.prompt)     # tokens still to feed
                req._steps = 0

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks), dtype=torch.int64,
                               device=self.device)

    def _pos_arr(self, pos):
        """Decode position operand: an int (flush mode) or a (B,) tensor."""
        if np.ndim(pos) == 0:
            return int(pos)
        return torch.as_tensor(np.asarray(pos, np.int32), device=self.device)

    def _fail(self, i: int, reason: str):
        s = self.slots[i]
        s.error = reason
        s.done = True
        self.slots[i] = None
        self.pos[i] = 0
        self.stats["failed"] += 1

    def _snapshot(self):
        """A copy of the caches (retries, probes, audits)."""
        return {k: v.clone() for k, v in self.caches.items()}

    def _probe_poison(self, fn, toks, pos, live) -> List[int]:
        """Which live slots does the decode failure follow?  Each probe
        decodes one slot's token, padding elsewhere, on a cache copy."""
        poison = []
        for i in live:
            t = np.zeros_like(toks)
            t[i] = toks[i]
            self.stats["probes"] += 1
            try:
                fn(self.params, self._tokens(t), self._snapshot(),
                   self._pos_arr(pos))
            except Exception:
                poison.append(i)
        return poison

    def _decode_isolated(self, fn, toks, pos, live):
        """The decode step with retry and poison isolation.

        Returns (logits, live); (None, live) when nothing is left to
        decode this step; re-raises when the failure is systemic.
        """
        donating = self.decode_fn is not None
        last = None
        for attempt in range(self.max_retries + 1):
            backup = self._snapshot() if donating and self.max_retries \
                else None
            try:
                logits, self.caches = fn(self.params, self._tokens(toks),
                                         self.caches, self._pos_arr(pos))
                return logits, live
            except Exception as e:
                last = e
                if backup is not None:
                    self.caches = backup
                if attempt < self.max_retries:
                    self.stats["retries"] += 1
                    if self.backoff > 0:
                        time.sleep(min(self.backoff * (2 ** attempt),
                                       self.backoff_cap))
        if self.max_retries == 0 and donating:
            # no retry budget means no snapshot was taken and a consuming
            # fn may have spent the caches: nothing to salvage
            raise last
        poison = self._probe_poison(fn, toks, pos, live)
        if not poison:
            raise last            # systemic: every single-slot probe passed
        for i in poison:
            self._fail(i, f"decode failed: {last!r}")
        live = [i for i in live if i not in poison]
        if not live:
            return None, live
        toks = toks.copy()
        for i in poison:
            toks[i] = 0
        logits, self.caches = fn(self.params, self._tokens(toks),
                                 self.caches, self._pos_arr(pos))
        return logits, live

    def _guard_slots(self, logits, toks, pos, pre_caches, live) -> List[int]:
        """Live slots whose runtime guards tripped on this step's logits."""
        if self.guard is None:
            return []
        arr = logits.to(torch.float32).cpu().numpy()
        ok = finite_rows(arr) if self.guard.finite \
            else np.ones(arr.shape[0], bool)
        if self.guard.budget_active and pre_caches is not None \
                and self.stats["steps"] % self.guard.budget_every == 0:
            # sampled accuracy audit: the same step on the exact datapath
            exact_logits, _ = self._exact_fn()(self.params,
                                               self._tokens(toks),
                                               pre_caches,
                                               self._pos_arr(pos))
            err = np.abs(arr.astype(np.float64)
                         - exact_logits.cpu().numpy().astype(np.float64))
            ok &= np.where(np.isfinite(err), err, np.inf).mean(axis=-1) \
                <= self.guard.budget_abs
        tripped = [i for i in live if not ok[i]]
        self.stats["guard_trips"] += len(tripped)
        return tripped

    def _rt_exact(self) -> ModelRuntime:
        """This scheduler's runtime with the approximate datapath off."""
        cfg_off = dataclasses.replace(self.rt.amm.cfg, mode="off")
        return dataclasses.replace(self.rt, amm=AmmRuntime(cfg_off))

    def _exact_fn(self):
        return make_serve_fns(self.cfg, self._rt_exact())[1]

    def _reserve_exact(self, req: Request):
        """Regenerate one guard-tripped request on the exact datapath:
        from-scratch greedy decode at batch 1."""
        self.stats["exact_reserves"] += 1
        fn = self._exact_fn()
        caches = init_cache(self.cfg, 1, self.max_len, device=self.device)
        req.out = []
        pending = list(req.prompt)
        tok = pending.pop(0) if pending else 0
        pos = 0
        while len(req.out) < req.max_new and pos < self.max_len - 1:
            logits, caches = fn(self.params, self._tokens([[tok]]), caches,
                                pos)
            pos += 1
            if pending:
                tok = pending.pop(0)
            else:
                tok = int(_argmax_rows(logits)[0])
                req.out.append(tok)
        req.exact = True
        req.done = True

    # ------------------------------------------------- continuous batching
    def _finish(self, i: int):
        """Complete slot ``i``: evict and free it for the next admission."""
        s = self.slots[i]
        s.done = True
        self.slots[i] = None
        self.pos[i] = 0
        self.stats["completed"] += 1

    def _prefill_slot(self, i: int):
        """Prefill slot ``i``'s prompt as one batch-1 dispatch on a copy
        of the slot's cache slice, written back on success; the prefill's
        last logits give the first generated token.  An empty prompt
        prefills the pad token 0."""
        req = self.slots[i]
        toks = list(req.prompt) or [0]
        fn = self.prefill_fn or self._prefill_default
        sub = slot_take(self.caches, self._bax, i)
        last = None
        for attempt in range(self.max_retries + 1):
            try:
                logits, sub = fn(self.params, self._tokens([toks]), sub)
                break
            except Exception as e:
                last = e
                if attempt < self.max_retries:
                    self.stats["retries"] += 1
                    if self.backoff > 0:
                        time.sleep(min(self.backoff * (2 ** attempt),
                                       self.backoff_cap))
        else:
            self._fail(i, f"prefill failed: {last!r}")
            return
        self.caches = slot_put(self.caches, self._bax, sub, i)
        self.pos[i] = len(toks)
        self.stats["prefills"] += 1
        self.stats["decoded"] += len(toks)
        req._pending = []
        req.out.append(int(_argmax_rows(logits)[0]))
        if len(req.out) >= req.max_new or self.pos[i] >= self.max_len - 1:
            self._finish(i)

    def _step_continuous(self) -> int:
        """One continuous-batching step: admit, prefill, decode residents."""
        admitted = 0
        for i in range(len(self.slots)):
            if not self.queue or admitted >= self.max_prefills_per_step:
                break
            if self.slots[i] is None:
                req = self.queue.pop(0)
                self.slots[i] = req
                req._steps = 0
                req._pending = []
                self.pos[i] = 0
                self.caches = reset_slot(self.caches, self._bax, i)
                self._prefill_slot(i)    # may fail or finish the slot
                admitted += 1
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return 0
        self.stats["steps"] += 1
        toks = np.zeros((len(self.slots), 1), np.int32)
        for i in live:
            toks[i, 0] = self.slots[i].out[-1]
        pos = self.pos.copy()   # (B,): dead slots write pad at 0, wiped on
        fn = self.decode_fn or self._default_fn       # the next admission
        audit = (self.guard is not None and self.guard.budget_active
                 and self.stats["steps"] % self.guard.budget_every == 0)
        pre_caches = self._snapshot() if audit else None
        n_live = len(live)
        logits, live = self._decode_isolated(fn, toks, pos, live)
        if logits is None:
            return n_live
        for i in self._guard_slots(logits, toks, pos, pre_caches, live):
            self._reserve_exact(self.slots[i])
            self.slots[i] = None
            self.pos[i] = 0
            live = [j for j in live if j != i]
        nxt = _argmax_rows(logits)
        for i in live:
            s = self.slots[i]
            self.pos[i] += 1
            s._steps += 1
            self.stats["decoded"] += 1
            s.out.append(int(nxt[i]))
            if len(s.out) >= s.max_new or self.pos[i] >= self.max_len - 1:
                self._finish(i)
            elif s.deadline is not None and s._steps >= s.deadline:
                self._fail(i, "deadline")
                self.stats["deadline_expired"] += 1
        return n_live

    def step(self) -> int:
        """One decode step over all live slots; returns #live requests."""
        if self.continuous:
            return self._step_continuous()
        self._admit()
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return 0
        self.stats["steps"] += 1
        toks = np.zeros((len(self.slots), 1), np.int32)
        for i in live:
            s = self.slots[i]
            # peek, don't pop: the prompt token is consumed only once the
            # decode call commits, so a retried step does not lose it
            toks[i, 0] = (s._pending[0] if s._pending
                          else (s.out[-1] if s.out else 0))
        pos = int(self.pos[live[0]])   # homogeneous-pos simplification
        fn = self.decode_fn or self._default_fn
        audit = (self.guard is not None and self.guard.budget_active
                 and self.stats["steps"] % self.guard.budget_every == 0)
        pre_caches = self._snapshot() if audit else None
        n_live = len(live)
        logits, live = self._decode_isolated(fn, toks, pos, live)
        if logits is None:
            return n_live
        for i in self._guard_slots(logits, toks, pos, pre_caches, live):
            self._reserve_exact(self.slots[i])
            self.slots[i] = None
            live = [j for j in live if j != i]
        nxt = _argmax_rows(logits)
        for i in live:
            s = self.slots[i]
            self.pos[i] += 1
            s._steps += 1
            self.stats["decoded"] += 1
            if s._pending:
                s._pending.pop(0)       # committed: the step consumed it
            if not s._pending:
                # prompt drained: this step's logits predict past the
                # prompt, so the step that consumes the last prompt token
                # also emits the first generated token
                s.out.append(int(nxt[i]))
                if len(s.out) >= s.max_new:
                    s.done = True
                    self.slots[i] = None
                    self.stats["completed"] += 1
                    continue
            if self.pos[i] >= self.max_len - 1:
                # cache positions exhausted: finish (or fail, mid-prompt)
                if s._pending:
                    self._fail(i, "context exhausted mid-prompt")
                else:
                    s.done = True
                    self.slots[i] = None
                    self.stats["completed"] += 1
            elif s.deadline is not None and s._steps >= s.deadline:
                self._fail(i, "deadline")
                self.stats["deadline_expired"] += 1
        return n_live
