"""RWKV-6 "Finch" [arXiv:2404.05892]: the SSM family, an attention-free LM
with data-dependent per-channel decay.

The port of the JAX package's ``models/rwkv6.py``.  A block is a time-mix
(the wkv linear recurrence) and a channel-mix (squared-ReLU FFN), both with
token-shift interpolation whose mix coefficients get a low-rank
data-dependent correction (the LoRA MLPs of the paper).  Per head
(K = V = head_dim)::

    y_t     = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t     = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(logw_t)

with ``logw = -exp(w0 + tanh(x_w @ w_down) @ w_up)`` (the up product cast
to float32 first).  The recurrence goes through
``kernels/linear_scan.py::wkv``: with ``cfg.attention_impl == "kernel"``
CUDA tensors take the hand-written scan kernel; otherwise (and on the CPU)
the plain chunked version, a twin of the JAX ``wkv_chunked`` with chunk
``cfg.attention_chunk``.  The JAX model calls ``wkv_chunked`` and never its
own Pallas kernel; both compute the same function.

The JAX semantics are kept, not upstream RWKV's: ``ln_x`` is a layer norm
over all H*K channels (not a per-head group norm), and ``decode_step`` is
``prefill`` of one token.

Training: ``loss_fn`` (the JAX one) runs ``forward``, which starts from a
zero state and writes nothing in place, so autograd sees every layer's
state; under ``remat`` ``"full"`` or ``"dots"`` with grad enabled each
block runs under ``torch.utils.checkpoint`` (as ``jax.checkpoint`` there,
which the JAX model applies under both).  The wkv scan
kernel has no backward (neither has the JAX one, which trains through
``wkv_chunked``), so a training config keeps ``attention_impl`` off
``"kernel"`` and the time-mix takes ``wkv_plain``; ``wkv(impl="kernel")``
raises under autograd.

Dtype flow, as in the JAX package: ``init_cache`` makes the token-shift
states float32 zeros, so at prefill ``_token_shift`` promotes the shifted
stream to float32 and the mix runs in float32 before its cast to the
compute dtype; the states a call returns are the last token in the compute
dtype, so every later decode step mixes in the compute dtype.

Tensor-parallel compute.  In a rank's partitioned step
(``sharding.api.compute_axes()``, ``launch/steps.py``) each layer gathers
its FSDP blocks over the DP group and computes its wkv heads (``H / m``,
the state's block on the model axis): ``wr`` / ``wk`` / ``wv`` / ``wg``
are column blocks of the rank's heads, so ``wkv`` (the scan kernel on the
card) runs on them; ``w0``, ``u`` and ``ln_x`` are cut to the rank's
columns; ``ln_x``'s mean and centred sum of squares over all ``H * K``
channels are summed over the model axis (``layers.layer_norm(group=)``);
``wo`` is row-parallel (one all-reduce).  The LoRAs' blocks cross the
mixes and the heads (``mix_down``'s 160 columns split 10 a rank against
five groups of 32; ``w_down``'s ``D`` split), so ``mix_down``,
``mix_up`` and ``w_down`` are gathered whole and run alike on every rank
(their backward pass reduce-scatters the partial gradients).  The channel
mix: ``cm_wk`` column- and ``cm_wv`` row-parallel, the partial sum
reduce-scattered to the rank's ``D`` columns, which ``cm_wr``'s column
block gates, and the gated columns gathered.  The token-shift states and
every ``[B, S, D]`` stream stay whole on the model axis; the embedding,
head and loss are vocabulary-parallel (``layers.embed_tokens`` /
``vocab_logits`` / ``next_token_loss``).

Parameter dict (the JAX tree's names and layouts, so
``repro_torch.convert.model_params_from_numpy`` copies it as it is):

  embed [V, D]; ln_in {scale, bias} [D]
  layers/  stacked [L, ...]:
    ln1, ln2 {scale, bias} [D]
    mix_base [5, D]; mix_down [D, 5*Rm]; mix_up [5, Rm, D]   (r,k,v,g,w)
    wr, wk, wv, wg [D, H*K]; wo [H*K, D]
    w0 [H*K]; w_down [D, Rd]; w_up [Rd, H*K]; u [H, K]
    ln_x {scale, bias} [H*K]
    cm_mix_k, cm_mix_r [D]; cm_wk [D, F]; cm_wv [F, D]; cm_wr [D, D]
  final_norm {scale, bias} [D]; lm_head [D, V]
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, dtype_of
from repro_torch.device import resolve_device
from repro_torch.kernels.linear_scan import wkv
from repro_torch.models.layers import (embed_tokens, init_linear, layer_norm,
                                       model_slice, model_whole,
                                       next_token_loss, remat_block,
                                       unbind_layers, vocab_logits)
from repro_torch.sharding import collectives as C
from repro_torch.sharding import spmd
from repro_torch.sharding.api import compute_axes

__all__ = ["init_params", "param_shapes", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step", "RWKVState", "check_supported"]

_MIX_NAMES = ("r", "k", "v", "g", "w")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config this module cannot run."""
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"models.rwkv6 runs the ssm family, not {cfg.family!r}")


# -----------------------------------------------------------------------------
# init
# -----------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (tuples), keyed as ``init_params``."""
    check_supported(cfg)
    n, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    h, hd, v = cfg.num_heads, cfg.head_dim, cfg.padded_vocab
    hk, rm, rd = h * hd, cfg.rwkv_mix_lora, cfg.rwkv_decay_lora
    nm = len(_MIX_NAMES)

    def norm(*lead, width):
        return {"scale": (*lead, width), "bias": (*lead, width)}

    layers = {
        "ln1": norm(n, width=d), "ln2": norm(n, width=d),
        "mix_base": (n, nm, d), "mix_down": (n, d, rm * nm),
        "mix_up": (n, nm, rm, d),
        "wr": (n, d, hk), "wk": (n, d, hk), "wv": (n, d, hk),
        "wg": (n, d, hk), "wo": (n, hk, d),
        "w0": (n, hk), "w_down": (n, d, rd), "w_up": (n, rd, hk),
        "u": (n, h, hd), "ln_x": norm(n, width=hk),
        "cm_mix_k": (n, d), "cm_mix_r": (n, d),
        "cm_wk": (n, d, f), "cm_wv": (n, f, d), "cm_wr": (n, d, d),
    }
    return {"embed": (v, d), "ln_in": norm(width=d), "layers": layers,
            "final_norm": norm(width=d), "lm_head": (d, v)}


# float32 constants of the JAX init, by name: value
_CONSTANTS = {"mix_base": 0.5, "cm_mix_k": 0.5, "cm_mix_r": 0.5, "w0": -6.0,
              "u": 0.0}


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device: "torch.device | str | None" = None) -> dict:
    """Random parameters drawn from ``generator`` on ``device`` (default
    ``"cuda"``; the generator must live there too) with the JAX package's
    scales and constants: ``normal / sqrt(d_in)`` for every projection,
    ``0.02 * normal`` for the embedding and ``mix_up``; norms one/zero,
    ``mix_base`` and the channel-mix coefficients 0.5, ``w0`` -6 and the
    bonus ``u`` zero, all float32.  The numbers differ from the JAX
    package's for the same seed."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    dtype = dtype_of(cfg.param_dtype)
    f32 = dict(dtype=torch.float32, device=device)

    def norm(shape):
        return {"scale": torch.ones(shape["scale"], **f32),
                "bias": torch.zeros(shape["bias"], **f32)}

    layers = {}
    for name, shape in shapes["layers"].items():
        if isinstance(shape, dict):
            layers[name] = norm(shape)
        elif name in _CONSTANTS:
            layers[name] = torch.full(shape, _CONSTANTS[name], **f32)
        elif name == "mix_up":
            layers[name] = init_linear(generator, *shape[-2:], dtype=dtype,
                                       scale=0.02, device=device,
                                       lead=shape[:-2])
        else:
            layers[name] = init_linear(generator, *shape[1:], dtype=dtype,
                                       device=device, lead=shape[:1])
    return {
        "embed": init_linear(generator, *shapes["embed"], dtype=dtype,
                             scale=0.02, device=device),
        "ln_in": norm(shapes["ln_in"]),
        "layers": layers,
        "final_norm": norm(shapes["final_norm"]),
        "lm_head": init_linear(generator, *shapes["lm_head"], dtype=dtype,
                               device=device),
    }


# -----------------------------------------------------------------------------
# blocks
# -----------------------------------------------------------------------------


def _token_shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """The x_{t-1} stream.  ``last`` ``[B, D]`` is carried across calls
    (zero when None); the result takes the promoted dtype of the two, as
    ``jnp.concatenate`` does."""
    if last is None:
        last = torch.zeros_like(x[:, 0])
    dt = torch.promote_types(x.dtype, last.dtype)
    return torch.cat([last[:, None].to(dt), x[:, :-1].to(dt)], dim=1)


def _time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
              state: torch.Tensor | None, shift_last: torch.Tensor | None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    hd = cfg.head_dim
    tp = compute_axes()
    group = None if tp is None else tp.model_group
    mix_base, w0, u, ln_x = p["mix_base"], p["w0"], p["u"], p["ln_x"]
    mix_down, mix_up, w_down = p["mix_down"], p["mix_up"], p["w_down"]
    if tp is not None:
        # the LoRAs whole on every rank (their blocks cross the mixes and
        # the heads), the per-channel leaves cut to the rank's heads
        x = C.copy_to(x, group)
        mix_base = C.copy_to(mix_base, group)
        mix_down = model_whole(mix_down, tp, ("layers", "mix_down"))
        mix_up = model_whole(mix_up, tp, ("layers", "mix_up"))
        w_down = model_whole(w_down, tp, ("layers", "w_down"))
        w0, u = model_slice(w0, -1, tp), model_slice(u, 0, tp)
        ln_x = {k: model_slice(t, -1, tp) for k, t in ln_x.items()}
    delta = _token_shift(x, shift_last) - x
    # data-dependent mix coefficients (lora)
    low = torch.tanh(x @ mix_down).reshape(b, s, len(_MIX_NAMES), -1)
    corr = torch.einsum("bsnr,nrd->bsnd", low, mix_up)
    mixed = x[:, :, None] + delta[:, :, None] * (
        mix_base[None, None].to(x.dtype) + corr)     # [B,S,5,D]
    xr, xk, xv, xg, xw = mixed.to(x.dtype).unbind(2)

    h = p["wr"].shape[-1] // hd     # the rank's heads in a partitioned step
    r = (xr @ p["wr"]).reshape(b, s, h, hd)
    k = (xk @ p["wk"]).reshape(b, s, h, hd)
    v = (xv @ p["wv"]).reshape(b, s, h, hd)
    g = xg @ p["wg"]
    logw = -torch.exp(w0[None, None].float()
                      + (torch.tanh(xw @ w_down) @ p["w_up"]).float())
    y, new_state = wkv(r, k, v, logw.reshape(b, s, h, hd), u,
                       state0=state, chunk=cfg.attention_chunk,
                       impl=cfg.attention_impl)
    # ln_x normalises all H*K channels: its moments summed over the group
    y = layer_norm(y.reshape(b, s, h * hd), ln_x["scale"], ln_x["bias"],
                   group=group)
    y = y * F.silu(g)
    out = y @ p["wo"]
    if tp is not None:
        out = C.reduce_from(out, group)
    return out, new_state, x[:, -1]


def _channel_mix(p: dict, x: torch.Tensor, shift_last: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    tp = compute_axes()
    mix_k, mix_r = p["cm_mix_k"], p["cm_mix_r"]
    if tp is not None:
        x = C.copy_to(x, tp.model_group)
        mix_k = C.copy_to(mix_k, tp.model_group)
        mix_r = C.copy_to(mix_r, tp.model_group)
    delta = _token_shift(x, shift_last) - x
    xk = (x + delta * mix_k[None, None].to(x.dtype)).to(x.dtype)
    xr = (x + delta * mix_r[None, None].to(x.dtype)).to(x.dtype)
    hidden = torch.square(torch.relu(xk @ p["cm_wk"]))
    value = hidden @ p["cm_wv"]
    if tp is not None:
        # ``cm_wv`` is row-parallel and ``cm_wr`` column-parallel: the
        # partial sums reduce-scattered to the rank's D columns, gated
        # there, and the gated columns gathered
        value = C.scatter_from(value, -1, tp.model_group)
        out = torch.sigmoid(xr @ p["cm_wr"]) * value
        return C.gather_from(out, -1, tp.model_group), x[:, -1]
    out = torch.sigmoid(xr @ p["cm_wr"]) * value
    return out, x[:, -1]


def _block(p: dict, x: torch.Tensor, cfg: ModelConfig, wkv_state, tm_last,
           cm_last):
    tp = compute_axes()
    if tp is not None:
        p = spmd.fsdp_gather(p, tp, ("layers",))
    h = layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"])
    tm_out, wkv_state, tm_last = _time_mix(p, h, cfg, wkv_state, tm_last)
    x = x + tm_out
    h = layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"])
    cm_out, cm_last = _channel_mix(p, h, cm_last)
    return x + cm_out, wkv_state, tm_last, cm_last


# -----------------------------------------------------------------------------
# model API (mirrors transformer.py)
# -----------------------------------------------------------------------------


@dataclasses.dataclass
class RWKVState:
    """The recurrent state every layer carries across calls.

    ``prefill`` and ``decode_step`` write the new ``wkv`` states into the
    ``wkv`` tensor in place (saving a copy of it per step) and return a
    state over that same tensor, with new shift tensors in the compute
    dtype and the new length."""
    wkv: torch.Tensor       # [L, B, H, K, K] float32
    shift_tm: torch.Tensor  # [L, B, D]  last token fed to the time-mix
    shift_cm: torch.Tensor  # [L, B, D]  last token fed to the channel-mix
    length: int             # tokens seen; kept on the host


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype: torch.dtype | None = None,
               device: "torch.device | str | None" = None) -> RWKVState:
    """A zero state on ``device`` (default ``"cuda"``).  Its size does not
    grow with the sequence, so ``max_len`` and ``dtype`` are accepted for
    the uniform ``init_cache`` signature and unused, as in the JAX
    package; the shift states start float32, as there."""
    device = resolve_device(device)
    l, d = cfg.num_layers, cfg.d_model
    h, hd = cfg.num_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return RWKVState(wkv=torch.zeros((l, batch, h, hd, hd), **f32),
                     shift_tm=torch.zeros((l, batch, d), **f32),
                     shift_cm=torch.zeros((l, batch, d), **f32),
                     length=0)


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    h = embed_tokens(params, tokens, cfg)
    return layer_norm(h, params["ln_in"]["scale"], params["ln_in"]["bias"])


def _run(params: dict, h: torch.Tensor, cfg: ModelConfig, cache: RWKVState,
         *, keep_state: bool = True
         ) -> tuple[torch.Tensor, RWKVState | None]:
    """Every block from ``cache``'s state.  With ``keep_state`` the new
    ``wkv`` states are written into ``cache.wkv`` in place and the new
    state is returned (the serving pair); without it nothing is written and
    the state is dropped (``forward``, which autograd differentiates).
    With grad enabled each block runs as ``layers.remat_block`` runs it:
    under ``torch.utils.checkpoint`` for ``remat`` ``"full"`` and
    ``"dots"``."""
    tms, cms = [], []
    for i, p in enumerate(unbind_layers(params)):
        h, new_wkv, tm, cm = remat_block(
            cfg.remat, _block, p, h, cfg, cache.wkv[i], cache.shift_tm[i],
            cache.shift_cm[i])
        if keep_state:
            cache.wkv[i].copy_(new_wkv)
            tms.append(tm)
            cms.append(cm)
    if not keep_state:
        return h, None
    return h, RWKVState(wkv=cache.wkv, shift_tm=torch.stack(tms),
                        shift_cm=torch.stack(cms),
                        length=cache.length + h.shape[1])


def _logits(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = layer_norm(h, params["final_norm"]["scale"],
                   params["final_norm"]["bias"])
    return vocab_logits(params, h, cfg)


def forward(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """-> logits ``[B, S, V]`` from a zero state (the JAX ``forward``'s
    first output; the SSM family has no auxiliary loss)."""
    h = _embed(params, batch["tokens"], cfg)
    state = init_cache(cfg, h.shape[0], 0, device=h.device)
    tp = compute_axes()
    if tp is not None:      # the rank's heads
        state.wkv = state.wkv[:, :, :cfg.num_heads
                              // tp.model_size].contiguous()
    h, _ = _run(params, h, cfg, state, keep_state=False)
    return _logits(params, h, cfg)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy (the JAX ``loss_fn``): ``forward``'s logits
    cast to float32, log-softmax, the negative log-likelihood of
    ``labels`` averaged over the positions with ``labels >= 0``."""
    return next_token_loss(forward(params, batch, cfg).float(),
                           batch["labels"], cfg)


def prefill(params: dict, batch: dict, cfg: ModelConfig, cache: RWKVState
            ) -> tuple[torch.Tensor, RWKVState]:
    """Run the prompt from ``cache``'s state; return the last position's
    logits ``[B, 1, V]`` and the state after it (its ``wkv`` updated in
    place)."""
    h = _embed(params, batch["tokens"], cfg)
    h, cache = _run(params, h, cfg, cache)
    return _logits(params, h[:, -1:], cfg), cache


def decode_step(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                cache: RWKVState) -> tuple[torch.Tensor, RWKVState]:
    """One decode step: ``prefill`` of tokens ``[B, 1]``."""
    return prefill(params, {"tokens": tokens}, cfg, cache)
