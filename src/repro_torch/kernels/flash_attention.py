"""Flash attention: the port of the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``.

On a CUDA tensor :func:`flash_attention` launches a hand-written Hopper
kernel, by the route :func:`attention_route` chooses and
``flash_attention.launches_by_route`` counts: ``"wgmma"``
(``csrc/flash_attention_wgmma.cu``, bf16 on the tensor cores) or
``"simt"`` (``csrc/flash_attention.cu``, f32 FMA). On a CPU tensor it runs
the plain version ``ref.flash_attention_ref``. There is no other route.
The SIMT kernel splits each query tile's keys across a thread-block
cluster of ``plan_attention(...).splits`` blocks, and stages K and V by
``cp.async`` or by plain loads as :func:`attention_staging` says
(``flash_attention.launches_by_staging`` counts each); a cluster the card
cannot place raises.

The causal mask is bottom-right aligned (query row i sees keys
``j <= i + Sk - Sq``), as the JAX package's plain reference masks; its
Pallas kernel masks top-left, and the two differ when ``Sq != Sk``
(ROADMAP Queue 3). Causal attention with ``Sq > Sk`` is refused: its first
rows see no key, the reference gives NaN there and the Pallas kernel
another number. The wgmma route rounds the probabilities to bf16 before
they multiply v, as tensor-core flash kernels do (ROADMAP Queue 3).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build
from .ref import flash_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
D_MAX = 128  # simt: D / 32 accumulator columns per lane, up to 4; wgmma: D padded to 128
_P, _I = ctypes.c_void_p, ctypes.c_int


ROUTES = ("wgmma", "simt")


def attention_route(dtype: torch.dtype, d: int, ptrs) -> str:
    """The kernel of one ``flash_attention`` call with head width ``d`` and
    q, k, v, out at addresses ``ptrs``. A pure function, so the rule is
    tested on the CPU. bf16 takes ``"wgmma"`` where TMA can describe the
    tensors: ``d`` a multiple of 8 (16-byte rows) and every address 16-byte
    aligned. Everything else, float32 included, takes ``"simt"``. An
    explicit route, not a fallback: a failed build or launch raises."""
    if dtype == torch.bfloat16 and d % 8 == 0 and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "simt"


STAGINGS = ("cp_async", "plain")


def attention_staging(dtype: torch.dtype, d: int, ptrs) -> str:
    """How the SIMT kernel stages K and V for one call with head width ``d``
    and q, k, v at addresses ``ptrs[:3]``. A pure function, tested on the
    CPU. ``"cp_async"`` (16-byte asynchronous copies, tile t + 1 in flight
    while tile t is computed) where each row is whole 16-byte words: float32,
    ``d % 4 == 0`` and q, k, v 16-byte aligned. Everything else, bfloat16
    included (its tiles are converted to float32 as they are staged), takes
    ``"plain"`` loads."""
    if dtype == torch.float32 and d % 4 == 0 and all(p % 16 == 0 for p in ptrs[:3]):
        return "cp_async"
    return "plain"


ATTN_BLOCK_Q = 64  # flash_attention.cu's kBQ: query rows per block
ATTN_KEY_UNIT = 16  # kKeyUnit: a split's keys are whole units of 16
ATTN_SPLITS = (1, 2, 4, 8)  # cluster sizes the kernel launches (portable)
ATTN_SLACK = 1.125  # the fewest splits within this factor of the best estimate


@dataclass(frozen=True)
class AttnPlan:
    block_q: int  # query rows per block
    splits: int  # blocks of one cluster sharing a query tile's keys

    def key_ranges(self, k_end: int) -> list[tuple[int, int]]:
        """Each split's ``[start, stop)`` of the ``k_end`` keys one query
        tile needs, in whole units of ``ATTN_KEY_UNIT`` keys, as the kernel
        cuts them; a range is empty where there are fewer units than
        splits."""
        units = -(-k_end // ATTN_KEY_UNIT)
        return [(ATTN_KEY_UNIT * (r * units // self.splits),
                 min(k_end, ATTN_KEY_UNIT * ((r + 1) * units // self.splits)))
                for r in range(self.splits)]


def k_end(q0: int, block_q: int, sq: int, sk: int, causal: bool) -> int:
    """The keys the query tile of rows ``[q0, q0 + block_q)`` needs: all
    ``sk``, or causally (bottom-right) up to its last row's last key."""
    return min(sk, min(sq, q0 + block_q) + sk - sq) if causal else sk


def plan_attention(bh: int, sq: int, sk: int, d: int, causal: bool,
                   sms: int = _build.H100_SMS) -> AttnPlan:
    """How the SIMT kernel covers one call: ``block_q`` rows a block, and
    each query tile's keys split across ``splits`` blocks of a cluster. A
    pure function, so the rule is tested on the CPU. The estimate of each
    choice is the larger of the heaviest block's keys and the keys each SM
    takes when the blocks spread over all ``sms`` SMs; the fewest splits
    within ``ATTN_SLACK`` of the best estimate win, so a grid that already
    fills the card is not split, and no split is given less than one unit
    of keys. ``d`` does not change the rule: both shared-memory instances
    hold one block at least on every SM."""
    tiles = -(-sq // ATTN_BLOCK_Q)
    need = [k_end(t * ATTN_BLOCK_Q, ATTN_BLOCK_Q, sq, sk, causal) for t in range(tiles)]
    total = bh * sum(need)
    units = -(-max(need) // ATTN_KEY_UNIT)
    estimate = {}
    for splits in ATTN_SPLITS:
        if splits > max(1, units):
            break
        heaviest = ATTN_KEY_UNIT * -(-units // splits)
        estimate[splits] = max(heaviest, total / min(sms, bh * tiles * splits))
    best = min(estimate.values())
    splits = min(s for s, e in estimate.items() if e <= ATTN_SLACK * best)
    return AttnPlan(ATTN_BLOCK_Q, splits)


@functools.cache
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


@functools.cache
def _wgmma_launcher():
    fn = _build.load("flash_attention_wgmma").flash_attention_wgmma_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q, k, v of one type, float32 or bfloat16, "
                        f"not {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, H, Sq, D) and k, v (B, H, Sk, D), "
                         f"not {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape[:2] != q.shape[:2] or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in B, H or D (GQA callers repeat the K/V heads first)")
    if not 0 < d <= D_MAX:
        raise ValueError(f"flash_attention takes 0 < D <= {D_MAX}, not D={d}")
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    if causal and sq > sk:
        raise ValueError(f"causal flash_attention needs Sq <= Sk, not Sq={sq} > Sk={sk}: "
                         f"the first rows would see no key")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if not q.device == k.device == v.device:
        raise ValueError(f"flash_attention takes q, k, v on one device, not "
                         f"{q.device}, {k.device}, {v.device}")
    if b * h > 65535 or max(sq, sk) * d >= 2**31 or -(-sq // ATTN_BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention: B·H={b * h}, Sq={sq}, Sk={sk}, D={d} is past "
                         f"the kernel's grid")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, plan: AttnPlan | None = None) -> torch.Tensor:
    """Softmax attention of q (B, H, Sq, D) over k, v (B, H, Sk, D), scale
    ``1/sqrt(D)``, in ``q.dtype`` (float32 or bfloat16), with float32
    running max, normaliser and accumulator, through the route
    :func:`attention_route` chooses; the SIMT route covers the call as
    ``plan`` says (default :func:`plan_attention`'s; another is for
    probes). ``flash_attention.launches`` counts the kernels' launches,
    ``flash_attention.launches_by_route`` the launches of each route and
    ``flash_attention.launches_by_staging`` the SIMT route's by staging."""
    _check(q, k, v, causal)
    if plan is not None and (plan.block_q != ATTN_BLOCK_Q or plan.splits not in ATTN_SPLITS):
        raise ValueError(f"flash_attention cannot launch {plan}: block_q is {ATTN_BLOCK_Q}, "
                         f"splits one of {ATTN_SPLITS}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.get_device() != torch.cuda.current_device():
        with torch.cuda.device(q.device):  # the runtime launches on the current device
            return flash_attention(q, k, v, causal=causal, plan=plan)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    if b * h == 0 or sq == 0:
        return out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    route = attention_route(q.dtype, d, ptrs)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sk = k.shape[2]
    if route == "wgmma":
        err = _wgmma_launcher()(*ptrs, b * h, sq, sk, d, int(causal), stream)
    else:
        if plan is None:
            plan = plan_attention(b * h, sq, sk, d, causal, _build.sm_count(q.get_device()))
        staging = attention_staging(q.dtype, d, ptrs)
        err = _launcher()(*ptrs, b * h, sq, sk, d, int(causal), _DTYPE_CODES[q.dtype],
                          plan.splits, int(staging == "cp_async"), stream)
    _build.check(err, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    if route == "simt":
        flash_attention.launches_by_staging[staging] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention.launches_by_staging = dict.fromkeys(STAGINGS, 0)
