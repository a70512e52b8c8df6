"""Carry state of the JAX package across to the port.

Three kinds of state cross over.  For the closed loop: transform plans,
characterization tables (with their wire-size proxy), the latency regression
and padded controller tables, so both packages can run the loop from one
and the same characterization.  For the model zoo: a model's parameter tree
(``model_params_from_numpy``, every family's), so both packages can serve
with the same weights, and an RWKV recurrent state
(``rwkv_state_from_numpy``), a zamba2 cache (``zamba_cache_from_numpy``)
or an enc-dec cache (``encdec_cache_from_numpy``), so both can decode from
the same state.  For the camera node: a device frame ring
(``frame_log_from_numpy``), so both can query the same log.  Each function
takes plain NumPy arrays and Python scalars -- nothing of the JAX package
is imported -- and returns the port's object.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.characterization import (CharacterizationTable,
                                               LatencyRegression)
from repro_torch.core.controller import ControllerTables
from repro_torch.core.grid_engine import WireSizeProxy
from repro_torch.core.knobs import KnobSetting
from repro_torch.core.log import FrameLog
from repro_torch.device import resolve_device
from repro_torch.kernels.frame_knobs import TransformPlan
from repro_torch.models.encdec import EncDecCache
from repro_torch.models.mamba2 import Mamba2State
from repro_torch.models.registry import build_model
from repro_torch.models.rwkv6 import RWKVState
from repro_torch.models.zamba2 import ZambaCache

__all__ = ["plan_from_numpy", "table_from_numpy", "regression_from_numpy",
           "controller_tables_from_numpy", "model_params_from_numpy",
           "rwkv_state_from_numpy", "zamba_cache_from_numpy",
           "encdec_cache_from_numpy", "opt_state_from_numpy",
           "frame_log_from_numpy"]


def plan_from_numpy(*, cs, scale, blur_ks, art_modes, in_h, in_w, packed_h,
                    out_h, out_w, n_planes, ry, rx, bys, bxs, art_ids,
                    blur_ids) -> TransformPlan:
    """A ``TransformPlan`` from the fields of one (resolution, colorspace)
    plan: the dense operators as f32 arrays, the ids as i32 arrays.  The
    band form is derived from the dense operators."""
    return TransformPlan(
        cs=int(cs), scale=float(scale), blur_ks=tuple(int(k) for k in blur_ks),
        art_modes=tuple(int(a) for a in art_modes), in_h=int(in_h),
        in_w=int(in_w), packed_h=int(packed_h), out_h=int(out_h),
        out_w=int(out_w), n_planes=int(n_planes),
        ry=np.asarray(ry, np.float32), rx=np.asarray(rx, np.float32),
        bys=np.asarray(bys, np.float32), bxs=np.asarray(bxs, np.float32),
        art_ids=np.asarray(art_ids, np.int32),
        blur_ids=np.asarray(blur_ids, np.int32))


def table_from_numpy(*, settings, sizes_sorted, best_acc, best_idx,
                     acc_by_setting, size_by_setting, proxy_coeffs=None,
                     proxy_median_rel_err: float = 0.0,
                     proxy_max_rel_err: float = 0.0,
                     min_accuracy: float = 0.90, source: str = "offline",
                     activity: float | None = None,
                     residual_spread: float | None = None
                     ) -> CharacterizationTable:
    """A ``CharacterizationTable`` from its arrays.  ``settings`` is an
    [n, 5] integer array of knob codes (resolution, colorspace, blur,
    artifact, diff); ``proxy_coeffs`` ([3, 2, 8], or None for a table
    without a wire-size proxy) and the two error figures rebuild its
    ``WireSizeProxy``."""
    codes = np.asarray(settings, np.int64).reshape(-1, 5)
    proxy = None
    if proxy_coeffs is not None:
        proxy = WireSizeProxy(np.asarray(proxy_coeffs, np.float64),
                              float(proxy_median_rel_err),
                              float(proxy_max_rel_err))
    return CharacterizationTable(
        settings=tuple(KnobSetting(*(int(c) for c in row)) for row in codes),
        sizes_sorted=np.asarray(sizes_sorted),
        best_acc=np.asarray(best_acc),
        best_idx=np.asarray(best_idx),
        acc_by_setting=np.asarray(acc_by_setting),
        size_by_setting=np.asarray(size_by_setting),
        proxy=proxy, min_accuracy=float(min_accuracy), source=str(source),
        activity=None if activity is None else float(activity),
        residual_spread=(None if residual_spread is None
                         else float(residual_spread)))


def regression_from_numpy(*, slope: float, intercept: float
                          ) -> LatencyRegression:
    """The latency regression ``latency = slope * bytes + intercept``."""
    return LatencyRegression(float(slope), float(intercept))


def controller_tables_from_numpy(*, sizes_sorted, best_acc, best_idx,
                                 n_valid, codes,
                                 device: "str | torch.device | None" = None
                                 ) -> ControllerTables:
    """``ControllerTables`` from already padded arrays (``sizes_sorted``
    +inf and ``best_idx`` -1 beyond ``n_valid``, ``codes`` [capacity, 5]),
    with or without a leading lane axis, on ``device`` (default
    ``"cuda"``)."""
    dev = resolve_device(device)
    return ControllerTables(   # torch.tensor copies: the port owns them
        torch.tensor(np.asarray(sizes_sorted, np.float32), device=dev),
        torch.tensor(np.asarray(best_acc, np.float32), device=dev),
        torch.tensor(np.asarray(best_idx, np.int32), device=dev),
        torch.tensor(np.asarray(n_valid, np.int32), device=dev),
        torch.tensor(np.asarray(codes, np.int32), device=dev))


def _tensor_from_numpy(a, *, device: "str | torch.device" = "cpu"
                      ) -> torch.Tensor:
    """A copy of ``a`` on ``device``.  A bfloat16 array (``ml_dtypes``, as
    ``np.asarray`` gives one of a bfloat16 JAX array) crosses bit for bit
    through a uint16 view."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def model_params_from_numpy(cfg, tree: dict, *,
                            device: "str | torch.device | None" = None
                            ) -> dict:
    """The port's parameter dict of ``cfg`` (a ``repro_torch`` ModelConfig)
    from a JAX ``init_params`` tree with every leaf as a NumPy array.

    Both packages keep one layout: stacked ``[L, ...]`` layers, projections
    as ``[d_in, d_out]`` (``y = x @ W``), the embedding ``[V, D]`` that a
    tied head reads as ``embed.T``.  So every leaf crosses as it is, with
    no transpose; its key set and shape are checked against the family
    module's ``param_shapes(cfg)`` and anything else raises
    ``ValueError``.  Dtypes are kept (the float32 leaves of a bfloat16
    tree -- norm scales, the MoE router, Mamba2's ``A_log``, ``D``,
    ``dt_bias`` and ``norm_scale`` -- stay float32).  ``device`` defaults to
    ``"cuda"``."""
    dev = resolve_device(device)

    def walk(shapes: dict, node: dict, path: str) -> dict:
        if set(shapes) != set(node):
            raise ValueError(f"{path or 'params'}: keys {sorted(node)}, "
                             f"want {sorted(shapes)}")
        out = {}
        for k, want in shapes.items():
            if isinstance(want, dict):
                out[k] = walk(want, node[k], f"{path}{k}/")
                continue
            a = np.asarray(node[k])
            if tuple(a.shape) != tuple(want):
                raise ValueError(f"{path}{k}: shape {a.shape}, want {want}")
            out[k] = _tensor_from_numpy(a, device=dev)
        return out

    return walk(build_model(cfg).module.param_shapes(cfg), tree, "")


def rwkv_state_from_numpy(*, wkv, shift_tm, shift_cm, length,
                          device: "str | torch.device | None" = None
                          ) -> RWKVState:
    """The port's ``RWKVState`` from the fields of a JAX ``RWKVState`` as
    NumPy arrays: ``wkv`` ``[L, B, H, K, K]``, the two shifts ``[L, B, D]``
    (dtypes kept: float32 before a prefill, the compute dtype after) and
    ``length`` (a scalar array or int, kept on the host).  ``device``
    defaults to ``"cuda"``."""
    dev = resolve_device(device)
    wkv = _tensor_from_numpy(wkv, device=dev)
    tm = _tensor_from_numpy(shift_tm, device=dev)
    cm = _tensor_from_numpy(shift_cm, device=dev)
    if wkv.dim() != 5 or tm.shape != cm.shape \
            or tuple(tm.shape) != tuple(wkv.shape[:2]) + (tm.shape[-1],):
        raise ValueError(f"RWKVState: wkv [L,B,H,K,K] and shifts [L,B,D] "
                         f"expected, got {tuple(wkv.shape)}, "
                         f"{tuple(tm.shape)}, {tuple(cm.shape)}")
    return RWKVState(wkv=wkv.float(), shift_tm=tm, shift_cm=cm,
                     length=int(length))


def zamba_cache_from_numpy(*, ssm, conv, attn_k, attn_v, length,
                           device: "str | torch.device | None" = None
                           ) -> ZambaCache:
    """The port's ``ZambaCache`` from the fields of a JAX ``ZambaCache`` as
    NumPy arrays: ``ssm`` ``[L, B, H, P, N]`` (float32) and ``conv``
    ``[L, B, K-1, C]`` (its ``Mamba2State``), ``attn_k`` / ``attn_v``
    ``[n_inv, B, S_max, KH, HD]`` (dtypes kept) and ``length`` (a scalar
    array or int, kept on the host).  ``device`` defaults to ``"cuda"``."""
    dev = resolve_device(device)
    st = _tensor_from_numpy(ssm, device=dev)
    cv = _tensor_from_numpy(conv, device=dev)
    k = _tensor_from_numpy(attn_k, device=dev)
    v = _tensor_from_numpy(attn_v, device=dev)
    if st.dim() != 5 or cv.dim() != 4 or st.shape[:2] != cv.shape[:2] \
            or k.dim() != 5 or k.shape != v.shape \
            or k.shape[1] != st.shape[1]:
        raise ValueError(f"ZambaCache: ssm [L,B,H,P,N], conv [L,B,K-1,C] and "
                         f"attn_k/attn_v [n_inv,B,S_max,KH,HD] expected, got "
                         f"{tuple(st.shape)}, {tuple(cv.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return ZambaCache(ssm=Mamba2State(ssm=st.float(), conv=cv), attn_k=k,
                      attn_v=v, length=int(length))


def encdec_cache_from_numpy(*, enc_out, self_k, self_v, cross_k, cross_v,
                            length,
                            device: "str | torch.device | None" = None
                            ) -> EncDecCache:
    """The port's ``EncDecCache`` from the fields of a JAX ``EncDecCache``
    as NumPy arrays: ``enc_out`` ``[B, S_enc, D]``, ``self_k`` / ``self_v``
    ``[L, B, S_max, KH, HD]``, ``cross_k`` / ``cross_v`` ``[L, B, S_enc,
    KH, HD]`` (dtypes kept) and ``length`` (a scalar array or int, kept on
    the host).  ``device`` defaults to ``"cuda"``."""
    dev = resolve_device(device)
    eo, sk, sv, ck, cv = (_tensor_from_numpy(a, device=dev) for a in
                          (enc_out, self_k, self_v, cross_k, cross_v))
    if eo.dim() != 3 or sk.dim() != 5 or sk.shape != sv.shape \
            or ck.shape != cv.shape or ck.shape[:2] != sk.shape[:2] \
            or ck.shape[3:] != sk.shape[3:] \
            or (ck.shape[1], ck.shape[2]) != tuple(eo.shape[:2]):
        raise ValueError(f"EncDecCache: enc_out [B,S_enc,D], self_k/self_v "
                         f"[L,B,S_max,KH,HD] and cross_k/cross_v "
                         f"[L,B,S_enc,KH,HD] expected, got {tuple(eo.shape)}, "
                         f"{tuple(sk.shape)}, {tuple(ck.shape)}")
    return EncDecCache(enc_out=eo, self_k=sk, self_v=sv, cross_k=ck,
                       cross_v=cv, length=int(length))


def opt_state_from_numpy(cfg, tree: dict, *,
                         device: "str | torch.device | None" = None) -> dict:
    """The port's AdamW state of ``cfg``'s model from a JAX
    ``init_opt_state`` / ``adamw_update`` state with every leaf as a NumPy
    array: ``m`` and ``v`` (parameter-shaped trees, checked as
    ``model_params_from_numpy`` checks a parameter tree; float32 kept) and
    ``count`` (an int32 0-d tensor).  ``device`` defaults to ``"cuda"``."""
    dev = resolve_device(device)
    if set(tree) != {"m", "v", "count"}:
        raise ValueError(f"opt state: keys {sorted(tree)}, want "
                         f"['count', 'm', 'v']")
    return {"m": model_params_from_numpy(cfg, tree["m"], device=dev),
            "v": model_params_from_numpy(cfg, tree["v"], device=dev),
            "count": torch.tensor(int(np.asarray(tree["count"])),
                                  dtype=torch.int32, device=dev)}


def frame_log_from_numpy(*, timestamps, payload, head, count, last_ts,
                         rejects, device: "str | torch.device | None" = None
                         ) -> FrameLog:
    """The port's ``FrameLog`` from the leaves of a JAX ``FrameLog`` as
    NumPy arrays: ``timestamps`` float32 ``[capacity]``, ``payload``
    ``[capacity, *frame_shape]`` (dtype kept), and the int32 scalars
    ``head``, ``count``, ``rejects`` and the float32 ``last_ts``.
    ``device`` defaults to ``"cuda"``."""
    dev = resolve_device(device)
    ts = np.asarray(timestamps)
    pl = np.asarray(payload)
    if ts.ndim != 1 or ts.dtype != np.float32 or pl.shape[:1] != ts.shape:
        raise ValueError(f"FrameLog: float32 timestamps [capacity] and a "
                         f"payload [capacity, ...] expected, got "
                         f"{ts.dtype} {ts.shape}, {pl.shape}")

    def scalar(a, dtype):
        a = np.asarray(a)
        if a.shape != ():
            raise ValueError(f"FrameLog: a scalar expected, got {a.shape}")
        return torch.tensor(a.astype(dtype), device=dev)

    return FrameLog(timestamps=_tensor_from_numpy(ts, device=dev),
                    payload=_tensor_from_numpy(pl, device=dev),
                    head=scalar(head, np.int32), count=scalar(count, np.int32),
                    last_ts=scalar(last_ts, np.float32),
                    rejects=scalar(rejects, np.int32))
