"""Recurrent blocks, ported from ``repro.models.ssm``: the selective-SSM
(Mamba) heads of hymba and the xLSTM blocks (mLSTM and sLSTM) of xlstm.

- ``mamba_shapes`` / ``init_mamba`` — one block's parameters, in the
  reference's key order and with its distributions.
- ``mamba_seq`` — the full-sequence block: input projection, depthwise
  causal conv, SiLU, discretisation, the selective scan, the SiLU gate and
  the output projection; it also returns the state after the last step
  and the conv tail, the decode cache a prefill hands on.
- ``mamba_decode`` — one token of the same block from that state and tail.
- ``xlstm_shapes`` / ``init_xlstm`` — one xLSTM block's parameters (one
  layout for mLSTM and sLSTM), in the reference's key order.
- ``chunked_linear_scan`` — h_t = a_t h_{t-1} + b_t in chunks, a
  Hillis–Steele scan inside each chunk with the reference's ``combine``.
- ``mlstm_seq`` / ``slstm_seq`` — the two xLSTM cores over the full
  sequence, with the reference's stabilisers; each also returns its
  recurrent state after the last step, (C, n, m) and (c, n, m).
- ``mlstm_decode`` / ``slstm_decode`` — one token of each core from that
  state, the reference's O(1) recurrent forms.

Weights arrive shared by the whole batch, x (..., S, d), or one set per
client, x (m, B, S, d) with every leaf carrying a leading m axis, as
``linear`` / ``per_client`` in ``models/common.py`` take them.

The discretisation computes only dt = softplus(x w_dt + b_dt), B = x w_b
and C = x w_c, (..., S, D) and (..., S, N), in fp32 whatever the model's
type, as the reference's ``_ssm_coeffs`` does (so a bf16 model feeds the
scan fp32 inputs, and casts y back after it); the (B, S, D, N) decay and
drive of the reference's ``_ssm_coeffs`` are never built: the scan
(``repro_torch.kernels.mamba_scan``) discretises inside its own time loop,
as the TPU kernel does.  On CUDA tensors it runs the hand-written kernel,
forward and backward; on CPU tensors its plain version.  The reference's
``ssm.fuse_contraction`` and ``ssm.chunk`` choose the layout of its JAX
associative scan; neither changes a number, and neither has a counterpart
here.  The scan kernel writes the final state in the same launch.  The
decode steps are plain PyTorch, as the reference's are ``jnp``.  A
sequence form starts from the zero state (the reference's optional
``state`` and ``conv_tail`` inputs are not ported: its prefill never
passes them).

``mamba_seq(..., tp=mesh)`` runs on a rank's blocks of the weights
(``sharding.shard_tree`` under the baseline policy: every ``ffn`` axis of
``mamba_specs`` split over ``model``), tensor-parallel over ``model``:
rank r of M owns channels [r D / M, (r + 1) D / M) and holds those rows
or columns of ``conv_w``, ``a_log``, ``w_dt``, ``b_dt``, ``d_skip``,
``w_b``, ``w_c`` and ``w_out``.  ``w_in`` (d, 2D) is split by columns
across its [raw | z] halves (at model 2 one rank holds raw, the other z),
so it is gathered whole for the layer (its gradient summed over ``model``
before each rank takes its slice: each rank uses it for its own channels)
and the rank takes columns [r D / M, ...) of each half.  ``B = x w_b`` and
``C = x w_c`` contract over the channels, so each rank's product is a
partial sum: it is summed over ``model`` forward and, since every rank's
scan uses the summed B and C for different channels, its cotangent is
summed over ``model`` backward too.  The scan then runs on the rank's
(B, S, D / M) channels; ``w_out``'s row block gives a partial output that
is summed over ``model``.  Where ``model`` does not divide D the channel
leaves stay whole: ``w_in`` is gathered if it is split, and the block is
computed replicated over ``model``.  ``mamba_decode(..., tp=mesh)`` steps
the same blocks one token at a time; its state and conv tail come and go
whole over ``model`` (the cache's layout: batch rows only), the rank
advancing its channels and the new ones gathered over ``model``.

The xLSTM cores have no TPU kernel in the reference and none here: their
products are ``torch.matmul``.  ``ssm.chunk`` is the mLSTM chunk and the
sLSTM scan chunk, as in the reference.  ``mlstm_seq`` / ``slstm_seq`` /
``mlstm_decode`` / ``slstm_decode`` take ``tp=mesh`` too (``xlstm_specs``:
``w_up``'s columns, ``wq`` / ``wk`` / ``wv``'s head columns and
``w_down``'s head rows split over ``model``; ``w_if``, ``b_if`` and
``core_norm`` replicated).  ``wq``, ``wk`` and ``wv`` each contract over
all of ``core_in``, so ``w_up`` (split by columns across its [core_in |
out_gate] halves) is gathered whole (its gradient summed over ``model``
first), ``core_in`` is computed whole on every rank and the out_gate on
the rank's channels; q, k, v and both halves of the gate logits on the
rank's heads (``w_if`` / ``b_if`` cut to their columns, their gradients
summed over ``model``; with ``core_in`` whole the logits are no partial
sum); the cores on the rank's heads; ``core_norm`` is an RMS norm over all
d channels, so its sum of squares is summed over ``model`` forward and
backward and the rank scales by its slice of the replicated scale;
``w_down``'s row block gives a partial output summed over ``model``.
Where ``model`` does not divide the heads (xlstm-125m's 4 at model 16)
the split leaves are gathered whole and the block is computed replicated.
The sequence forms return the rank's heads of the state; the decode forms
take and return it whole over ``model``, as the cache holds it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.models.common import (
    column_in,
    gather_whole,
    lecun_init,
    linear,
    per_client,
    rms_norm,
    row_out,
)

__all__ = ["mamba_shapes", "mamba_specs", "init_mamba", "mamba_seq", "mamba_decode",
           "chunked_linear_scan", "xlstm_shapes", "xlstm_specs", "init_xlstm", "mlstm_seq",
           "mlstm_decode", "slstm_seq", "slstm_decode"]

_NEG = -1e30  # the causal and initial-state fill: exp(_NEG - m) is 0, never NaN


def mamba_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Parameter shapes of one Mamba block, in the reference's key order.
    hymba's SSM heads run at model width: d_inner = d_model."""
    d, n, k = cfg.d_model, cfg.ssm.d_state, cfg.ssm.conv_kernel
    d_in = d
    return {"w_in": (d, 2 * d_in), "conv_w": (k, d_in), "a_log": (d_in, n), "w_dt": (d_in,),
            "b_dt": (d_in,), "w_b": (d_in, n), "w_c": (d_in, n), "d_skip": (d_in,),
            "w_out": (d_in, d)}


def mamba_specs(cfg) -> dict:
    """The logical axes of each leaf of ``init_mamba``'s tree."""
    return {"w_in": ("embed", "ffn"), "conv_w": (None, "ffn"), "a_log": ("ffn", "state"),
            "w_dt": ("ffn",), "b_dt": ("ffn",), "w_b": ("ffn", "state"),
            "w_c": ("ffn", "state"), "d_skip": ("ffn",), "w_out": ("ffn", "embed")}


def init_mamba(generator: torch.Generator, cfg) -> dict[str, torch.Tensor]:
    """fp32 parameters drawn from ``generator`` on its device with the
    reference's distributions: LeCun projections, N(0, 0.2^2) conv taps,
    a_log = log(1..N) on every channel, dt bias -4.6 (softplus ~ 0.01),
    unit skip."""
    shapes = mamba_shapes(cfg)
    dev = generator.device
    d_in, n = shapes["a_log"]
    return {
        "w_in": lecun_init(generator, shapes["w_in"]),
        "conv_w": torch.randn(shapes["conv_w"], generator=generator, device=dev) * 0.2,
        "a_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev)).repeat(d_in, 1),
        "w_dt": lecun_init(generator, shapes["w_dt"], fan_in=d_in),
        "b_dt": torch.full(shapes["b_dt"], -4.6, device=dev),
        "w_b": lecun_init(generator, shapes["w_b"]),
        "w_c": lecun_init(generator, shapes["w_c"]),
        "d_skip": torch.ones(shapes["d_skip"], device=dev),
        "w_out": lecun_init(generator, shapes["w_out"]),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as shifted adds, in the reference's order.
    x (..., S, D) with taps w (k, D), or x (m, B, S, D) with w (m, k, D)."""
    k, s = w.shape[-2], x.shape[-2]
    out = x * per_client(w[..., k - 1, :], x)
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[..., :s, :]
        out = out + shifted * per_client(w[..., k - 1 - i, :], x)
    return out


def _discretize(p, x_in: torch.Tensor):
    """(x, dt (..., S, D), B (..., S, N), C (..., S, N)), all fp32."""
    xf = x_in.to(torch.float32)
    dt = F.softplus(xf * per_client(p["w_dt"], xf) + per_client(p["b_dt"], xf))
    return (xf, dt, linear(xf, p["w_b"].to(torch.float32)),
            linear(xf, p["w_c"].to(torch.float32)))


def _conv_tail(ext: torch.Tensor, k: int) -> torch.Tensor:
    """The last k - 1 conv inputs (..., k - 1, D), fp32: the decode cache."""
    return ext[..., ext.shape[-2] - (k - 1):, :].to(torch.float32)


def _channel_block(p, cfg, mesh, split: bool) -> dict:
    """``p`` with ``w_in`` gathered whole where ``model`` splits it and, where
    the channel leaves are split (``split``), cut to this rank's columns of
    the raw half and of the z half (``mamba_seq``'s ``tp``)."""
    d, w_in = cfg.d_model, p["w_in"]
    if w_in.shape[-1] != 2 * d:
        w_in = gather_whole(w_in, mesh, 1, partial=split)
    if split:
        n = p["conv_w"].shape[-1]
        lo = mesh.axis_index("model") * n
        w_in = torch.cat([w_in[:, lo:lo + n], w_in[:, d + lo:d + lo + n]], dim=1)
    return {**p, "w_in": w_in}


def mamba_seq(p, cfg, x: torch.Tensor, tp=None):
    """Full-sequence selective SSM: x (..., S, d) -> (out (..., S, d),
    (h (..., D, N), conv_tail (..., k - 1, D))), the state after the last
    step and the last k - 1 conv inputs (zero-padded in front where S < k -
    1), both fp32.  ``tp``: the mesh whose ``model`` axis splits ``p`` (a
    rank's blocks; x replicated over ``model``), as the module's docstring
    says; h and the tail are then the rank's channels."""
    s, k = x.shape[-2], cfg.ssm.conv_kernel
    split = tp is not None and p["conv_w"].shape[-1] != cfg.d_model
    if tp is not None:
        p = _channel_block(p, cfg, tp, split)
    if split:
        x = column_in(x, tp)
    raw, z = linear(x, p["w_in"]).chunk(2, dim=-1)
    x_in = F.silu(_causal_conv(raw, p["conv_w"]))
    xf, dt, bmat, cmat = _discretize(p, x_in)
    if split:   # partial sums over the rank's channels, summed both ways
        bmat, cmat = (tp.all_reduce_sum(tp.grad_sum(t, "model"), "model") for t in (bmat, cmat))
    d_in, n = x_in.shape[-1], bmat.shape[-1]
    rows = math.prod(x_in.shape[:-2])
    y, h = mamba_scan(xf.reshape(rows, s, d_in), dt.reshape(rows, s, d_in),
                      bmat.reshape(rows, s, n), cmat.reshape(rows, s, n),
                      p["a_log"].contiguous(), p["d_skip"].contiguous(), final_state=True)
    out = linear(y.reshape(x_in.shape).to(x.dtype) * F.silu(z), p["w_out"])
    if split:
        out = row_out(out, tp)
    tail = _conv_tail(F.pad(raw, (0, 0, k - 1, 0)), k)
    return out, (h.reshape(*x_in.shape[:-2], d_in, n), tail)


def mamba_decode(p, cfg, x: torch.Tensor, state: torch.Tensor, conv_tail: torch.Tensor,
                 tp=None):
    """One token: x (B, 1, d), state (B, D, N) and conv_tail (B, k - 1, D)
    fp32 -> (out (B, 1, d), (state, conv_tail) after it), with the
    reference's arithmetic and order (fp32 discretisation, h = a h + b).
    ``tp``: on a rank's blocks, as ``mamba_seq``'s; the state and tail come
    and go whole over ``model``, the rank advancing its channels."""
    k = cfg.ssm.conv_kernel
    split = tp is not None and p["conv_w"].shape[-1] != cfg.d_model
    if tp is not None:
        p = _channel_block(p, cfg, tp, split)
    if split:
        n = p["conv_w"].shape[-1]
        lo = tp.axis_index("model") * n
        state, conv_tail = state[:, lo:lo + n], conv_tail[..., lo:lo + n]
    raw, z = linear(x, p["w_in"]).chunk(2, dim=-1)
    ext = torch.cat([conv_tail.to(raw.dtype), raw], dim=-2)
    x_in = F.silu(_causal_conv(ext, p["conv_w"])[..., -1:, :])
    xf, dt, bmat, cmat = _discretize(p, x_in)
    if split:   # partial sums over the rank's channels
        bmat, cmat = (tp.all_reduce_sum(t, "model") for t in (bmat, cmat))
    xf, dt, bmat, cmat = xf[..., 0, :], dt[..., 0, :], bmat[..., 0, :], cmat[..., 0, :]
    a = torch.exp(dt[..., None] * -torch.exp(p["a_log"]))                 # (B, D, N)
    h = a * state + dt[..., None] * bmat[..., None, :] * xf[..., None]
    y = (h * cmat[..., None, :]).sum(-1) + xf * p["d_skip"]
    out = linear(y[..., None, :].to(x.dtype) * F.silu(z), p["w_out"])
    tail = _conv_tail(ext, k)
    if split:
        out = row_out(out, tp)
        h, tail = tp.all_gather(h, "model", dim=1), tp.all_gather(tail, "model", dim=2)
    return out, (h, tail)


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) + sLSTM (scalar memory)
# ---------------------------------------------------------------------------


def xlstm_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Parameter shapes of one xLSTM block, in the reference's key order."""
    d, h = cfg.d_model, cfg.ssm.n_heads
    return {"w_up": (d, 2 * d), "wq": (d, d), "wk": (d, d), "wv": (d, d), "w_if": (d, 2 * h),
            "b_if": (2 * h,), "w_down": (d, d), "core_norm": (d,)}


def xlstm_specs(cfg) -> dict:
    """The logical axes of each leaf of ``init_xlstm``'s tree."""
    return {"w_up": ("embed", "ffn"), "wq": ("embed", "heads"), "wk": ("embed", "heads"),
            "wv": ("embed", "heads"), "w_if": ("embed", None), "b_if": (None,),
            "w_down": ("heads", "embed"), "core_norm": (None,)}


def init_xlstm(generator: torch.Generator, cfg) -> dict[str, torch.Tensor]:
    """fp32 parameters drawn from ``generator`` on its device with the
    reference's distributions: LeCun matrices, gate biases 0 (input) and 3
    (forget), zero core-norm scale."""
    shapes = xlstm_shapes(cfg)
    dev = generator.device
    h = cfg.ssm.n_heads
    p = {name: lecun_init(generator, shapes[name])
         for name in ("w_up", "wq", "wk", "wv", "w_if")}
    p["b_if"] = torch.cat([torch.zeros(h, device=dev), torch.full((h,), 3.0, device=dev)])
    p["w_down"] = lecun_init(generator, shapes["w_down"])
    p["core_norm"] = torch.zeros(shapes["core_norm"], device=dev)
    return {name: p[name] for name in shapes}


def chunked_linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, chunk: int):
    """h_t = a_t h_{t-1} + b_t along axis 1; a broadcasts against b (B, S,
    ...), h0 is (B, ...).  Returns (h_all (B, S, ...), h_final (B, ...)).

    Inside a chunk a Hillis–Steele scan: log2(chunk) steps of the
    reference's ``combine`` (earlier x, later y) -> (y_a x_a, y_a x_b +
    y_b), each over the whole chunk; the chunks run in order, each starting
    from the last state of the one before.  Nothing divides by a running
    product of a, which underflows to 0 within a chunk."""
    s = b.shape[1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence length {s} is not a multiple of the scan chunk {c}")
    a = a.reshape(*a.shape, *[1] * (b.ndim - a.ndim))
    outs, h = [], h0
    for start in range(0, s, c):
        acc_a, acc_b = a[:, start:start + c], b[:, start:start + c]
        step = 1
        while step < c:
            pad_a = torch.ones_like(acc_a[:, :step])
            pad_b = torch.zeros_like(acc_b[:, :step])
            prev_a = torch.cat([pad_a, acc_a[:, :-step]], dim=1)
            prev_b = torch.cat([pad_b, acc_b[:, :-step]], dim=1)
            acc_a, acc_b = acc_a * prev_a, acc_a * prev_b + acc_b
            step *= 2
        h_all = acc_a * h.unsqueeze(1) + acc_b
        outs.append(h_all)
        h = h_all[:, -1]
    return torch.cat(outs, dim=1), h


def _xlstm_blocks(p, cfg, tp):
    """``p`` on a rank's blocks (``tp``, the module's docstring) -> (p', tp',
    the rank's first head, its heads).  On whole heads: ``w_up`` gathered
    whole (its gradient summed over ``model`` first) and cut to all of its
    core_in half and the rank's columns of its out_gate half; ``w_if`` and
    ``b_if`` cut to the rank's heads' columns of both gate halves and
    ``core_norm`` to the rank's channels, each gradient summed over
    ``model``; tp' is ``tp``.  Where ``model`` does not divide the heads,
    every split leaf gathered whole and tp' None: the block is computed
    replicated."""
    d, h = cfg.d_model, cfg.ssm.n_heads
    m = tp.shape["model"]
    if p["wq"].shape[-1] == d or h % m:
        whole = dict(p)
        for k, dim, n in (("w_up", 1, 2 * d), ("wq", 1, d), ("wk", 1, d), ("wv", 1, d),
                          ("w_down", 0, d)):
            if p[k].shape[dim] != n:
                whole[k] = gather_whole(p[k], tp, dim)
        return whole, None, 0, h
    n, hl = d // m, h // m
    r = tp.axis_index("model")
    lo, a = r * n, r * hl
    w_up = gather_whole(p["w_up"], tp, 1, partial=True)
    w_if, b_if = (tp.grad_sum(p[k], "model") for k in ("w_if", "b_if"))
    return {**p, "w_up": torch.cat([w_up[:, :d], w_up[:, d + lo:d + lo + n]], dim=1),
            "w_if": torch.cat([w_if[:, a:a + hl], w_if[:, h + a:h + a + hl]], dim=1),
            "b_if": torch.cat([b_if[a:a + hl], b_if[h + a:h + a + hl]]),
            "core_norm": tp.grad_sum(p["core_norm"], "model")[lo:lo + n]}, tp, a, hl


def _xlstm_proj(p, cfg, x, heads=None):
    """q, k (scaled by 1/sqrt(hd)), v (..., S, H, hd); the input and
    forget-gate logits (..., S, H) in fp32 (the forget one as log f); the
    output gate (..., S, d).  ``heads``: the H of a rank's blocks
    (``_xlstm_blocks``), whose out_gate is then its (..., S, H hd)."""
    d = cfg.d_model
    h = heads or cfg.ssm.n_heads
    hd = d // cfg.ssm.n_heads
    up = linear(x, p["w_up"])
    core_in, out_gate = up[..., :d], up[..., d:]
    q = linear(core_in, p["wq"]).unflatten(-1, (h, hd))
    k = linear(core_in, p["wk"]).unflatten(-1, (h, hd)) / math.sqrt(hd)
    v = linear(core_in, p["wv"]).unflatten(-1, (h, hd))
    gates = linear(core_in.to(torch.float32), p["w_if"]) + per_client(p["b_if"], core_in)
    return q, k, v, gates[..., :h], F.logsigmoid(gates[..., h:]), out_gate


def _xlstm_out(p, cfg, x, y, out_gate, tp=None):
    """The core's (N, S, H, hd) output back to x's shape (its last axis the
    rank's H hd channels on blocks), normed, gated and projected down.  On
    blocks (``tp``) the RMS norm spans every head: its sum of squares is
    summed over ``model`` both ways, and ``w_down``'s row block gives a
    partial output summed over ``model``."""
    y = y.reshape(*x.shape[:-1], -1).to(x.dtype)
    y = rms_norm(y, per_client(p["core_norm"], y), cfg.norm_eps, mesh=tp)
    out = linear(y * F.silu(out_gate), p["w_down"])
    return out if tp is None else row_out(out, tp)


def _xlstm_state_in(state, tp, a, hl):
    """A decode state held whole over ``model`` (the cache's layout) cut to
    the rank's heads [a, a + hl) where ``tp`` splits them."""
    return state if tp is None else tuple(t[:, a:a + hl] for t in state)


def _xlstm_state_out(state, tp):
    """The rank's heads of a decode state gathered whole over ``model``."""
    return state if tp is None else tuple(tp.all_gather(t, "model", dim=1) for t in state)


def _exp_floor(m: torch.Tensor) -> torch.Tensor:
    """exp(-m), the mLSTM normaliser's floor, with the reference's values
    and a finite gradient where it overflows.

    Where every gate logit up to a position lies below -log(FLT_MAX)
    (about -88.7), exp(-m) is inf in fp32 and the output there is num / inf
    = 0, as in the reference.  Its true gradient is num exp(m), below fp32's
    range, but exp's backward multiplies the zero cotangent by the inf
    result and gives NaN, which the reference's ``jnp.exp(-m_new)`` does too.
    Here those positions take exp(0) on the differentiated branch, so they
    pass 0 back; every other position's value and gradient are exp's own."""
    over = torch.isinf(torch.exp(-m.detach()))
    return torch.where(over, torch.inf, torch.exp(torch.where(over, 0.0, -m)))


def mlstm_seq(p, cfg, x: torch.Tensor, tp=None):
    """Chunkwise-parallel mLSTM over the full sequence, x (..., S, d) ->
    (out (..., S, d), (C (..., H, hd, hd), n (..., H, hd), m (..., H))),
    the state after the last step, fp32, with the reference's stabilisers:
    the running maximum m of the exponential-gate logits, ``_NEG`` as the
    causal fill, the normaliser max(|n|, exp(-m)), and the state (C, n, m,
    F) carried from chunk to chunk.  One departure: where exp(-m)
    overflows, the gradient is 0, not the reference's NaN (``_exp_floor``).
    ``tp``: the mesh whose ``model`` axis splits ``p`` (a rank's blocks; x
    replicated over ``model``), as the module's docstring says; the state
    is then the rank's heads."""
    s = x.shape[-2]
    ck = min(cfg.ssm.chunk, s)
    if s % ck:
        raise ValueError(f"sequence length {s} is not a multiple of the mLSTM chunk {ck}")
    hl = None
    if tp is not None:
        p, tp, _, hl = _xlstm_blocks(p, cfg, tp)
        x = x if tp is None else column_in(x, tp)
    q, k, v, i_log, f_log, out_gate = _xlstm_proj(p, cfg, x, hl)
    # the batch axes folded into one, heads first: (N, H, S, hd) and (N, H, S)
    q, k, v = (t.reshape(-1, *t.shape[-3:]).transpose(1, 2).to(torch.float32) for t in (q, k, v))
    i_log, f_log = (t.reshape(-1, s, t.shape[-1]).transpose(1, 2) for t in (i_log, f_log))
    n_b, hh, _, hd = q.shape
    big_f = torch.cumsum(f_log, dim=-1)
    causal = torch.ones(ck, ck, dtype=torch.bool, device=x.device).tril()
    c_state = q.new_zeros(n_b, hh, hd, hd)
    n_state = q.new_zeros(n_b, hh, hd)
    m_state = q.new_full((n_b, hh), _NEG)
    f_prev = q.new_zeros(n_b, hh)
    ys = []
    for start in range(0, s, ck):
        sl = slice(start, start + ck)
        qb, kb, vb, fb, ib = q[:, :, sl], k[:, :, sl], v[:, :, sl], big_f[:, :, sl], i_log[:, :, sl]
        # intra-chunk decay logits D_ij = F_i - F_j + i_j (j <= i)
        lg = torch.where(causal, fb[..., :, None] - fb[..., None, :] + ib[..., None, :], _NEG)
        lg_state = fb - f_prev[..., None] + m_state[..., None]    # (N, H, cq)
        m_new = torch.maximum(lg.amax(-1), lg_state)
        w = (qb @ kb.transpose(-1, -2)) * torch.exp(lg - m_new[..., None])
        w_state = torch.exp(lg_state - m_new)
        num = w @ vb + (qb @ c_state) * w_state[..., None]
        den = torch.abs(w.sum(-1) + (qb @ n_state[..., None]).squeeze(-1) * w_state)
        ys.append(num / torch.maximum(den, _exp_floor(m_new))[..., None])
        # the state at the chunk's end
        f_end = fb[..., -1]
        m_cand = f_end - f_prev + m_state
        decay = f_end[..., None] - fb + ib                        # (N, H, ck)
        m_end = torch.maximum(decay.amax(-1), m_cand)
        wj = torch.exp(decay - m_end[..., None])[..., None] * kb
        keep = torch.exp(m_cand - m_end)
        c_state = keep[..., None, None] * c_state + wj.transpose(-1, -2) @ vb
        n_state = keep[..., None] * n_state + wj.sum(-2)
        m_state, f_prev = m_end, f_end
    lead = x.shape[:-2]
    out = _xlstm_out(p, cfg, x, torch.cat(ys, dim=2).transpose(1, 2), out_gate, tp)
    return out, (c_state.reshape(*lead, hh, hd, hd), n_state.reshape(*lead, hh, hd),
                 m_state.reshape(*lead, hh))


def mlstm_decode(p, cfg, x: torch.Tensor, state, tp=None):
    """One token of the mLSTM, x (B, 1, d), from its state (C, n, m) ->
    (out (B, 1, d), the state after it): the reference's recurrent form,
    with ``_exp_floor`` for the normaliser's exp(-m) as in ``mlstm_seq``.
    ``tp``: on a rank's blocks; the state comes and goes whole over
    ``model`` (every head), the rank advancing its own heads."""
    hl = a = None
    if tp is not None:
        p, tp, a, hl = _xlstm_blocks(p, cfg, tp)
    q, k, v, i_log, f_log, out_gate = _xlstm_proj(p, cfg, x, hl)
    c_state, n_state, m_state = _xlstm_state_in(state, tp, a, hl)
    i1, f1 = i_log[:, 0], f_log[:, 0]                             # (B, H)
    m_new = torch.maximum(f1 + m_state, i1)
    fp = torch.exp(f1 + m_state - m_new)
    ip = torch.exp(i1 - m_new)
    qf, kf, vf = (t[:, 0].to(torch.float32) for t in (q, k, v))   # (B, H, hd)
    c_state = fp[..., None, None] * c_state + ip[..., None, None] * (kf[..., :, None]
                                                                     * vf[..., None, :])
    n_state = fp[..., None] * n_state + ip[..., None] * kf
    num = (qf[..., None, :] @ c_state)[..., 0, :]
    den = torch.abs((qf * n_state).sum(-1))
    y = num / torch.maximum(den, _exp_floor(m_new))[..., None]
    return _xlstm_out(p, cfg, x, y, out_gate, tp), _xlstm_state_out((c_state, n_state, m_new),
                                                                     tp)


def slstm_seq(p, cfg, x: torch.Tensor, tp=None):
    """sLSTM over the full sequence, x (..., S, d) -> (out (..., S, d), (c
    (..., H, hd), n (..., H, hd), m (..., H))), the state after the last
    step, fp32: the reference's linearised form (no h -> gate feedback),
    per-head scalar memory with exponential gating.  The stabiliser m_t =
    max(f_t + m_{t-1}, i_t), the reference's (max, +) scan, is computed in
    closed form as F_t + cummax(i - F) with F = cumsum(log f); c and n are
    chunked linear scans (n the same for every dim of a head, broadcast to
    hd as the reference keeps it).  ``tp`` as for ``mlstm_seq``."""
    s = x.shape[-2]
    hl = None
    if tp is not None:
        p, tp, _, hl = _xlstm_blocks(p, cfg, tp)
        x = x if tp is None else column_in(x, tp)
    _, _, v, i_log, f_log, out_gate = _xlstm_proj(p, cfg, x, hl)
    z = torch.tanh(v.reshape(-1, *v.shape[-3:]).to(torch.float32))  # (N, S, H, hd)
    i_log, f_log = i_log.reshape(-1, s, i_log.shape[-1]), f_log.reshape(-1, s, f_log.shape[-1])
    big_f = torch.cumsum(f_log, dim=1)
    m_run = big_f + torch.cummax(i_log - big_f, dim=1).values
    m_prev = torch.cat([torch.full_like(m_run[:, :1], _NEG), m_run[:, :-1]], dim=1)
    fp = torch.exp(f_log + m_prev - m_run)[..., None]             # (N, S, H, 1)
    ip = torch.exp(i_log - m_run)[..., None]
    c_all, c_fin = chunked_linear_scan(fp, ip * z, torch.zeros_like(z[:, 0]), cfg.ssm.chunk)
    n_all, n_fin = chunked_linear_scan(fp, ip, torch.zeros_like(ip[:, 0]), cfg.ssm.chunk)
    y = c_all / torch.clamp(torch.abs(n_all), min=1e-6)
    lead, hh, hd = x.shape[:-2], z.shape[-2], z.shape[-1]
    return _xlstm_out(p, cfg, x, y, out_gate, tp), (
        c_fin.reshape(*lead, hh, hd), n_fin.expand(-1, hh, hd).reshape(*lead, hh, hd),
        m_run[:, -1].reshape(*lead, hh))


def slstm_decode(p, cfg, x: torch.Tensor, state, tp=None):
    """One token of the sLSTM, x (B, 1, d), from its state (c, n, m) ->
    (out (B, 1, d), the state after it): the reference's recurrent form.
    ``tp`` as for ``mlstm_decode``."""
    hl = a = None
    if tp is not None:
        p, tp, a, hl = _xlstm_blocks(p, cfg, tp)
    _, _, v, i_log, f_log, out_gate = _xlstm_proj(p, cfg, x, hl)
    z = torch.tanh(v[:, 0].to(torch.float32))                    # (B, H, hd)
    c_state, n_state, m_state = _xlstm_state_in(state, tp, a, hl)
    i1, f1 = i_log[:, 0], f_log[:, 0]
    m_new = torch.maximum(f1 + m_state, i1)
    fp = torch.exp(f1 + m_state - m_new)[..., None]
    ip = torch.exp(i1 - m_new)[..., None]
    c_state = fp * c_state + ip * z
    n_state = fp * n_state + ip
    y = c_state / torch.clamp(torch.abs(n_state), min=1e-6)
    return _xlstm_out(p, cfg, x, y, out_gate, tp), _xlstm_state_out((c_state, n_state, m_new),
                                                                     tp)
