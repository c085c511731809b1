"""Continuous-batching serving engine.

The counterpart of ``repro/serving/engine.py``, with the same behaviour and
the same launch descriptors. The engine keeps a fixed pool of KV-cache
*slots*; every decode launch advances whichever slots are live, each at its
own position, and a finished request's slot goes to the next queued request
at once.

* **Fused sampling** (``sampling="fused"``, the default): the decode launch
  samples on the device (:meth:`~repro_torch.models.model.Model.decode_and_sample`,
  backed by the hand-written ``greedy_sample`` kernel on the card) and
  returns ``(B, 1)`` token ids; the host blocks on a few bytes instead of the
  full ``(B, vocab)`` logits. The sampled ids stay on the device and feed
  the next launch, so the decode descriptor has no ``tokens`` leaf: the host
  injects tokens only through ``token_overrides``/``override_mask``
  (admissions and freed slots), which elide in steady-state decode.
  ``sampling="host"`` keeps the logits-returning launch and takes the argmax
  as a separate op on the device, copying back only the ids (the A/B
  baseline, with bit-identical token streams).

* **Batched prefill**: admission runs the prompt through
  :meth:`~repro_torch.models.model.Model.prefill_chunk` — ``ceil(p/chunk)``
  masked launches instead of p full-batch steps, each advancing *only* the
  admitted slot.

Every launch goes through a :class:`~repro_torch.dispatch.ScheduledExecutor`
(``engine.executor``): its :class:`~repro_torch.sched.state_cache.ConfigStateCache`
(``engine.config_cache``) splits each descriptor into sent vs.
device-resident fields, and its depth-bounded staging ring keeps prefill
launches in flight while the host prepares the next one.
``engine.config_traffic()`` reports the split.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.dispatch import ScheduledExecutor
from repro_torch.models.layers import COMPUTE_DTYPE


@dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, model, params, *, max_slots: int = 4, max_len: int = 256,
                 eos_id: int | None = None, launch_depth: int = 2,
                 decode_fn=None, prefill_fn=None, on_launch=None,
                 sampling: str = "fused", prefill_chunk: int = 8):
        if sampling not in ("fused", "host"):
            raise ValueError(f"sampling must be 'fused' or 'host', not {sampling!r}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, not {prefill_chunk}")
        self.model = model
        self.params = params
        self.device = model.device
        self.max_slots = max_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.sampling = sampling
        self.prefill_chunk = prefill_chunk
        self.cache = model.init_cache(max_slots, max_len)
        self.positions = np.zeros((max_slots,), np.int32)
        # host mirror of each slot's pending input token (the descriptor
        # field in host mode; bookkeeping only under fused sampling, where
        # the device-resident ids are the real input ring)
        self.tokens = np.zeros((max_slots, 1), np.int32)
        # fused sampling: host→device token injections for the next decode
        # launch (admitted prompts' last token; zero for freed slots) —
        # all-False mask in steady state, so both leaves elide
        self._overrides = np.zeros((max_slots,), np.int32)
        self._override_mask = np.zeros((max_slots,), bool)
        if sampling == "fused":
            # the device-resident sampled ids (previous launch's output,
            # next launch's input — never crosses the boundary)
            self._dev_tokens = torch.zeros((max_slots, 1), dtype=torch.int32,
                                           device=self.device)
        self.slot_req: list[Request | None] = [None] * max_slots
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        # decode_fn/prefill_fn let several engines of one model share one
        # step function; a caller-supplied decode_fn must match the
        # engine's sampling mode (use compile_decode(model, sampling=...))
        self._decode = decode_fn or ServingEngine.compile_decode(model, sampling=sampling)
        self._prefill = prefill_fn or ServingEngine.compile_prefill(model)
        # launch observer: called with every launch descriptor *after* it
        # goes through the executor (observation only, no reply)
        self.on_launch = on_launch
        # the staging ring waits on the per-launch payload (sampled ids /
        # logits / prefill probe); the KV cache is updated in place
        self.executor = ScheduledExecutor(self._device_fn, depth=launch_depth,
                                          tenant="engine",
                                          sync_fn=lambda out: out[1])
        self.config_cache = self.executor.cache

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device, non_blocking=True)

    def _device_fn(self, state, desc):
        """One launch from a cached descriptor. Three launch kinds share the
        path: chunked prefill (keyed by ``prefill_tokens``), fused decode
        (device-resident token ring + host overrides → sampled ids), and
        host-sampling decode (``tokens`` field → full logits)."""
        params, cache = state
        if "prefill_tokens" in desc:
            probe, cache = self._prefill(
                params, cache,
                self._dev(desc["prefill_tokens"]),
                self._dev(desc["positions"]),
                self._dev(desc["prefill_len"]),
                self._dev(desc["slot_mask"]),
            )
            return (params, cache), probe
        if self.sampling == "fused":
            ids, cache = self._decode(
                params, cache, self._dev_tokens,
                self._dev(desc["token_overrides"]),
                self._dev(desc["override_mask"]),
                self._dev(desc["positions"]),
                self._dev(desc["live_mask"]),
            )
            self._dev_tokens = ids  # loopback: next launch's input tokens
            return (params, cache), ids
        logits, cache = self._decode(
            params, cache, self._dev(desc["tokens"]),
            self._dev(desc["positions"]),
            self._dev(desc["live_mask"]),
        )
        return (params, cache), logits

    def _launch(self, desc: dict):
        """Stage one launch through the executor; adopts the cache and
        returns the (possibly still in-flight) per-launch payload."""
        (_, self.cache), out = self.executor.launch(
            (self.params, self.cache), desc
        )
        if self.on_launch is not None:
            self.on_launch(desc)
        return out

    @staticmethod
    def compile_decode(model, sampling: str = "fused"):
        """The decode step, shareable across every engine of the same model
        (`decode_fn=`). PyTorch runs eagerly, so this is the bound method:
        ``sampling="fused"`` gives the fused decode+sample step (ids out),
        ``"host"`` the logits-returning step. Must match the engines'
        ``sampling=``."""
        if sampling == "fused":
            return model.decode_and_sample
        return model.decode_step

    @staticmethod
    def compile_prefill(model):
        """The chunked-prefill launch (`prefill_fn=`), shareable like
        :meth:`compile_decode`."""
        return model.prefill_chunk

    # ---------------------------------------------------------------- admin

    def submit(self, req: Request) -> None:
        """Queue a request. Rejects prompts the slot layout cannot hold:
        an empty prompt has no token to start decode from, and a prompt of
        ``max_len`` or more would overrun the slot's KV rows before the
        first generated token."""
        if not req.prompt:
            raise ValueError(f"request {req.uid}: empty prompt")
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt of {len(req.prompt)} tokens "
                f"needs max_len > {len(req.prompt)} (engine max_len="
                f"{self.max_len}) — it would overrun the KV cache")
        self.queue.append(req)

    @property
    def live_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def _admit(self) -> None:
        for slot in range(self.max_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            self.slot_req[slot] = req
            self.positions[slot] = 0
            # chunked prefill: all prompt tokens but the last stream through
            # masked launches that advance only this slot; launches stay
            # staged in the executor's ring (no sync)
            ptoks = req.prompt[:-1]
            for start in range(0, len(ptoks), self.prefill_chunk):
                self._prefill_launch(slot, ptoks[start:start + self.prefill_chunk])
            # the prompt's last token seeds the first decode step
            self._set_token(slot, req.prompt[-1])

    def _prefill_launch(self, slot: int, chunk: list[int]) -> None:
        n = len(chunk)
        buf = np.zeros((self.prefill_chunk,), np.int32)
        buf[:n] = chunk
        mask = np.zeros((self.max_slots,), bool)
        mask[slot] = True
        self._launch({
            "prefill_tokens": buf,
            "prefill_len": np.int32(n),
            "positions": self.positions.copy(),
            "slot_mask": mask,
            **self._invariant_fields(),
        })
        self.positions[slot] += n

    def _set_token(self, slot: int, tok: int) -> None:
        """Point a slot's next decode input at ``tok`` — the host mirror
        always; plus a device override under fused sampling (the only way
        a host token enters the device-resident ring)."""
        self.tokens[slot, 0] = tok
        if self.sampling == "fused":
            self._overrides[slot] = tok
            self._override_mask[slot] = True

    # ----------------------------------------------------------------- step

    def step(self) -> int:
        """One decode launch over all live slots; returns #tokens produced."""
        self._admit()
        live = self.live_slots
        if not live:
            return 0
        out = self._launch(self._decode_descriptor(live))
        # sampling is the synchronization point. Fused: the launch already
        # sampled on the device — copy back (B, 1) ids, a few bytes. Host:
        # the launch returns the full (B, vocab) logits and the step waits on
        # them, then argmaxes them on their device and copies back the ids.
        if self.sampling == "fused":
            self._override_mask[:] = False  # consumed by the staged launch
            nxt = out[:, 0].cpu().numpy()
        else:
            nxt = torch.argmax(out[:, 0], dim=-1).to(torch.int32).cpu().numpy()
        produced = 0
        for slot in live:
            req = self.slot_req[slot]
            tok = int(nxt[slot])
            req.generated.append(tok)
            self.positions[slot] += 1
            self.tokens[slot, 0] = tok
            produced += 1
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if (
                len(req.generated) >= req.max_new_tokens
                or self.positions[slot] >= self.max_len - 1
                or hit_eos
            ):
                req.done = True
                self.finished.append(req)
                self.slot_req[slot] = None  # slot freed for the next request
                self.positions[slot] = 0
                # zero the freed slot's token state: later descriptors must
                # not carry (or dedup against) the dead request's last token
                self._set_token(slot, 0)
        return produced

    def _decode_descriptor(self, live: list[int]) -> dict:
        """The fields that parameterize one decode launch. Copies snapshot
        the mutable host buffers so cached values stay bit-stable. Fused
        sampling has no ``tokens`` leaf: input ids are device-resident, and
        the override pair is all-zero/all-False (elided) except on the step
        after an admission or a free."""
        mask = np.zeros((self.max_slots,), bool)
        mask[live] = True
        desc = {
            "positions": self.positions.copy(),
            "live_mask": mask,
            **self._invariant_fields(),
        }
        if self.sampling == "fused":
            desc["token_overrides"] = self._overrides.copy()
            desc["override_mask"] = self._override_mask.copy()
        else:
            desc["tokens"] = self.tokens.copy()
        return desc

    def _invariant_fields(self) -> dict:
        """Sampling/shape config common to every launch kind — sent once,
        device-resident (elided) afterwards."""
        return {
            "max_len": np.int32(self.max_len),
            "eos_id": np.int32(-1 if self.eos_id is None else self.eos_id),
            "n_slots": np.int32(self.max_slots),
        }

    @property
    def sync_bytes(self) -> int:
        """Device→host bytes the host blocks on per decode step, priced as
        the JAX engine prices them. Fused sampling returns ``(B, 1)`` int32
        ids; host sampling counts the full ``(B, vocab)`` logits the launch
        returns for the separate argmax."""
        if self.sampling == "fused":
            return self.max_slots * 4
        itemsize = torch.empty((), dtype=COMPUTE_DTYPE).element_size()
        return self.max_slots * self.model.cfg.vocab_size * itemsize

    def config_traffic(self) -> dict[str, float]:
        """Config bytes sent vs. elided across all launches so far
        (prefill and batch decode alike)."""
        s = self.config_cache.stats
        return {
            "bytes_sent": float(s.bytes_sent),
            "bytes_elided": float(s.bytes_elided),
            "elision_ratio": s.elision_ratio,
        }

    def run_until_done(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while (self.queue or self.live_slots) and steps < max_steps:
            self.step()
            steps += 1
        self.executor.drain()  # retire any still-staged launches
        return self.finished
