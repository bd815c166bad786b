"""Post-training int8 quantization (W8A8) for serving, on the int8 matmul K7.

Counterpart of ``ever_tpu/ops/ptq.py`` (``calibrate_int8``,
``quantize_convs``, ``ptq_quantize``, ``ptq_apply``,
``make_ptq_predict_fn``), with its formulas:

- **Calibration** runs batches through the unmodified model and records,
  for each covered layer, the float32 abs-max of its input (or, with
  ``act_percentile``, the linearly interpolated percentile of ``|x|[::s]``
  with ``s = max(1, numel // 2**20)``, the input flattened in the JAX
  package's layout: NHWC for a conv), reduced by a running max within a
  forward and across batches on the host.
- **Quantizing** gives each layer ``kernel_q = clip(rint(w / w_scale), ±127)``
  int8 with ``w_scale = max(|w|max / 127, 1e-12)`` float32 per output
  channel, and ``x_scale = float32(max(amax / 127.0, 1e-12))`` (the division
  in Python floats).  ``kernel_q`` is kept as K7 reads it: ``[Cout,
  Cin/g·kh·kw]`` for a conv (the OIHW reshape), ``[out, in]`` for a dense
  layer.  Layers whose ``kh·kw·Cin/g`` (or ``in``) is below
  ``min_in_features``, whose dotted name matches ``except_re``, or whose
  statistics are not finite and positive are skipped; no layer left raises.
- **Serving** quantizes a layer's input with torch's elementwise ops,
  ``x_q = clip(round_half_even(x.float() · (1 / x_scale)), ±127)`` int8 (the
  JAX package does this in XLA; it is not K6, whose nearest mode is
  ``floor(x/s + ½)``), runs the int32-accumulated product on K7
  (:func:`~ever_tpu_torch.ops.quant.int8_matmul_t`) with unit scales, so
  that its float32 result is the accumulator exactly, then multiplies by
  ``x_scale · w_scale`` (formed in float32), adds the float32 bias and casts
  to the dtype the floating-point layer returns: bit for bit the JAX
  formula.  A conv pads its int8 input (lax's asymmetric ``'SAME'`` where
  the layer uses it), gathers the ``[N·L, C·kh·kw]`` patch matrix (im2col,
  ``(C, kh, kw)`` order) and takes one K7 launch per group.

The covered layers are the port's counterparts of flax's ``nn.Conv`` and
``nn.Dense``: every ``nn.Conv2d`` (``module.ops.Conv2d`` included), every
``nn.Linear`` (``module.vit.Linear`` and the masked-bias
``LinearKMaskedBias``, whose bias is ``bias · bias_mask``), and the conv of
each ``module.vit.PatchEmbed``, which is applied at the ``PatchEmbed``
(it convolves with ``proj.weight`` without calling ``proj``).  A covered
layer outside the int8 vocabulary (a conv whose ``padding_mode`` is not
``'zeros'``, or whose input is not 4-d) runs in floating point, as the JAX
interceptor's own rule does; a layer with int8 weights otherwise runs K7
or raises.  Layers are named by their dotted module names, and
``except_re`` matches those (the JAX package matches flax's ``/`` paths).
The port's SwiGLU keeps the JAX package's fused ``w12`` as ``w1`` and
``w2``: two layers with one input, so one input scale, and one layer more
per block than the JAX package counts.

The port's model holds its weights, so the functions here take the
model's ``state_dict`` as ``variables`` (``infer_tool``'s triple gives it)
and run the model with its own parameters; ``ptq_apply`` reads only the
``'ptq'`` entry of the serving variables.  Interception is per call: the
covered layers' ``forward`` is replaced on the instances for the length
of one forward and restored after, so the model is unchanged outside it
and ``torch.export`` traces the int8 graph from inside.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ever_tpu_torch.ops import quant as _quant

__all__ = ['calibrate_int8', 'quantize_convs', 'ptq_quantize', 'ptq_apply',
           'make_ptq_predict_fn']

_QCOL = 'ptq'
# the percentile's subsample holds at most about this many elements
_SUBSAMPLE = 1 << 20


# ---------------------------------------------------------------------------
# the covered layers

def _sites(model: nn.Module) -> Dict[str, Tuple[nn.Module, nn.Module, str]]:
    """``{dotted name: (layer, site, kind)}`` of every covered layer:
    ``site`` is the module whose ``forward`` receives the layer's input,
    ``kind`` is ``'conv'`` (NCHW input), ``'dense'`` or ``'patch'`` (a
    ``PatchEmbed``'s conv, NHWC input at the ``PatchEmbed``)."""
    from ever_tpu_torch.module.vit import PatchEmbed
    out: Dict[str, Tuple[nn.Module, nn.Module, str]] = {}
    at_patch = set()
    for name, m in model.named_modules():
        if isinstance(m, PatchEmbed):
            out[f'{name}.proj' if name else 'proj'] = (m.proj, m, 'patch')
            at_patch.add(id(m.proj))
    for name, m in model.named_modules():
        if id(m) in at_patch:
            continue
        if isinstance(m, nn.Conv2d):
            out[name] = (m, m, 'conv')
        elif isinstance(m, nn.Linear):
            out[name] = (m, m, 'dense')
    return out


@contextlib.contextmanager
def _forwards(replacements: Dict[nn.Module, Callable]):
    """Each module's ``forward`` replaced on the instance inside the block,
    restored after (an instance's own ``forward`` included)."""
    saved = [(m, m.__dict__.get('forward')) for m in replacements]
    for m, fn in replacements.items():
        m.forward = fn
    try:
        yield
    finally:
        for m, before in saved:
            if before is None:
                del m.forward
            else:
                m.forward = before


def _as_input(a, device) -> Any:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if isinstance(a, np.ndarray) or hasattr(a, '__array__'):
        return torch.as_tensor(np.asarray(a), device=device)
    return a


def _model_device(model: nn.Module) -> torch.device:
    p = next(model.parameters(), None)
    return torch.device('cpu') if p is None else p.device


# ---------------------------------------------------------------------------
# calibration

def _act_stat(x: torch.Tensor, kind: str, percentile: Optional[float]) -> torch.Tensor:
    """Scalar float32 statistic of one layer input: the abs-max, or the
    ``percentile`` of |x| over a strided subsample, flattened in the JAX
    package's layout (an NCHW conv input as NHWC)."""
    if percentile is None:
        return x.detach().abs().amax().float()
    if kind == 'conv':
        x = x.permute(0, 2, 3, 1)
    ax = x.detach().float().abs().reshape(-1)
    stride = max(1, ax.numel() // _SUBSAMPLE)
    return torch.quantile(ax[::stride], percentile / 100.0)


def calibrate_int8(model: nn.Module, variables: Optional[Dict[str, torch.Tensor]],
                   batches: Iterable, apply_kwargs: Optional[Dict[str, Any]] = None,
                   act_percentile: Optional[float] = None) -> Dict[str, np.float32]:
    """Run calibration batches; return ``{layer name: input statistic}``.

    ``batches`` yields model inputs (tensors or arrays, or tuples of
    positional args; moved to the model's device).  ``variables`` is the
    model's ``state_dict`` (or None); the model runs with its own weights.
    Statistics are reduced with a running max across batches on the host
    (NaN propagates, as ``np.maximum`` does), so any number of batches costs
    one scalar per layer.  ``act_percentile`` (e.g. 99.9) replaces the
    abs-max with a percentile of |x| (module docstring).
    """
    del variables
    apply_kwargs = dict(apply_kwargs or {})
    sites = _sites(model)
    device = _model_device(model)
    stats: Optional[Dict[str, np.float32]] = None
    for b in batches:
        args = tuple(b) if isinstance(b, (tuple, list)) else (b,)
        args = tuple(_as_input(a, device) for a in args)
        seen: Dict[str, torch.Tensor] = {}

        def recorder(name, site, kind):
            forward = type(site).forward

            def record(x, *rest, **kw):
                stat = _act_stat(x, kind, act_percentile)
                seen[name] = stat if name not in seen else torch.maximum(seen[name], stat)
                return forward(site, x, *rest, **kw)
            return record

        with torch.no_grad(), _forwards({site: recorder(name, site, kind)
                                         for name, (_, site, kind) in sites.items()}):
            model(*args, **apply_kwargs)
        if stats is None:
            stats = {}
        for k, v in seen.items():
            v = np.float32(v.item())
            stats[k] = np.maximum(stats[k], v) if k in stats else v
    if stats is None:
        raise ValueError('calibrate_int8: no calibration batches provided')
    return stats


# ---------------------------------------------------------------------------
# weight and scale construction

def quantize_convs(variables: Dict[str, Any], stats: Dict[str, Any], *,
                   min_in_features: int = 0, except_re: Optional[str] = None) -> Dict:
    """Serving variables: ``variables`` and a ``'ptq'`` entry ``{layer name:
    {'kernel_q', 'w_scale', 'x_scale'}}``.

    For each layer with a statistic and a 2-d or 4-d ``{name}.weight`` in
    ``variables``: ``kernel_q`` int8 ``[out, in·kh·kw]`` (per-output-channel
    symmetric), ``w_scale`` float32 ``[out]``, ``x_scale`` a float32
    scalar, on the weight's device.  ``min_in_features`` skips layers
    whose ``kh·kw·Cin/g`` (or ``in``) is below it; ``except_re`` skips
    layers whose dotted name it matches (e.g. the classifier).
    """
    q: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, amax in stats.items():
        if isinstance(amax, (tuple, list)):
            amax = max(float(a) for a in amax) if amax else 0.0
        amax = float(amax)
        w = variables.get(f'{name}.weight' if name else 'weight')
        if w is None or w.dim() not in (2, 4):
            continue
        if int(np.prod(w.shape[1:])) < min_in_features:
            continue
        if except_re is not None and re.search(except_re, name):
            continue
        if not np.isfinite(amax) or amax <= 0.0:
            continue
        w32 = w.detach().float().reshape(w.shape[0], -1)
        w_absmax = w32.abs().amax(dim=1)
        if not bool(torch.isfinite(w_absmax).all()):
            continue
        w_scale = torch.clamp(w_absmax / 127.0, min=1e-12)
        kernel_q = torch.clamp(torch.round(w32 / w_scale[:, None]), -127, 127).to(torch.int8)
        x_scale = torch.tensor(np.float32(max(amax / 127.0, 1e-12)), device=w.device)
        q[name] = dict(kernel_q=kernel_q, w_scale=w_scale, x_scale=x_scale)
    if not q:
        raise ValueError('quantize_convs: no eligible convs found '
                         '(check calibration stats / filters)')
    out = dict(variables)
    out[_QCOL] = q
    return out


def ptq_quantize(model: nn.Module, variables: Optional[Dict[str, torch.Tensor]],
                 batches: Iterable, *, min_in_features: int = 0,
                 except_re: Optional[str] = None,
                 apply_kwargs: Optional[Dict[str, Any]] = None,
                 act_percentile: Optional[float] = None) -> Dict:
    """Calibrate and quantize in one call; returns serving variables.
    ``variables`` None means ``model.state_dict()``."""
    if variables is None:
        variables = model.state_dict()
    stats = calibrate_int8(model, variables, batches, apply_kwargs=apply_kwargs,
                           act_percentile=act_percentile)
    return quantize_convs(variables, stats, min_in_features=min_in_features,
                          except_re=except_re)


# ---------------------------------------------------------------------------
# serving

def _quantize_act(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``clip(round_half_even(x · inv), ±127)`` as int8, in float32."""
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)


def _im2col(x_q: torch.Tensor, kernel_size, stride, dilation, groups: int):
    """The patch matrices of padded NCHW ``x_q``, one ``[N·oh·ow,
    C/g·kh·kw]`` a group in ``(C, kh, kw)`` order (the OIHW reshape), and
    ``(oh, ow)``: strided views of ``x_q`` and one gather each."""
    (kh, kw), (sh, sw), (dh, dw) = kernel_size, stride, dilation
    n, c = x_q.shape[:2]
    v = x_q.unfold(2, (kh - 1) * dh + 1, sh).unfold(3, (kw - 1) * dw + 1, sw)
    v = v[..., ::dh, ::dw].permute(0, 2, 3, 1, 4, 5)   # [N, oh, ow, C, kh, kw]
    oh, ow = v.shape[1], v.shape[2]
    cg = c // groups
    cols = [v[:, :, :, g * cg:(g + 1) * cg].reshape(n * oh * ow, cg * kh * kw)
            for g in range(groups)]
    return cols, (oh, ow)


def _conv_pads(layer: nn.Conv2d, h: int, w: int) -> Tuple[int, int, int, int]:
    """``(top, bottom, left, right)`` zero padding of the layer's conv."""
    from ever_tpu_torch.module.ops import _lax_same
    if getattr(layer, 'lax_same', False):
        (t, b), (le, r) = (_lax_same(n, k, s, d) for n, k, s, d in zip(
            (h, w), layer.kernel_size, layer.stride, layer.dilation))
        return t, b, le, r
    p = layer.padding
    if p == 'valid':
        return 0, 0, 0, 0
    if p == 'same':
        (t, b), (le, r) = ((d * (k - 1) // 2, d * (k - 1) - d * (k - 1) // 2)
                           for k, d in zip(layer.kernel_size, layer.dilation))
        return t, b, le, r
    return p[0], p[0], p[1], p[1]


class _Int8Layer:
    """One covered layer's int8 forward: its prepared ``kernel_q`` ``[N,
    K]``, ``inv = 1 / x_scale`` and ``scale = x_scale · w_scale`` (float32),
    and the serving plan it reports its calls to."""

    def __init__(self, layer, site, kind, kernel_q, inv, scale, plan):
        self.layer, self.site, self.kind = layer, site, kind
        self.kernel_q, self.inv, self.scale, self.plan = kernel_q, inv, scale, plan

    def _product(self, cols, groups: int) -> torch.Tensor:
        """K7 over each group's patch matrix, float32 ``[M, Cout]``."""
        one = self.plan.one
        if groups == 1:
            return _quant.int8_matmul_t(cols[0].contiguous(), one, self.kernel_q, one)
        n = self.kernel_q.shape[0] // groups
        return torch.cat([_quant.int8_matmul_t(c.contiguous(), one,
                                               self.kernel_q[g * n:(g + 1) * n], one)
                          for g, c in enumerate(cols)], dim=1)

    def _finish(self, acc: torch.Tensor, dtype) -> torch.Tensor:
        y = acc * self.scale
        bias = self.layer.bias
        if bias is not None:
            mask = getattr(self.layer, 'bias_mask', None)
            y = y + (bias if mask is None else bias * mask).float()
        self.plan.int8_calls += 1
        return y.to(dtype)

    def dense(self, x):
        shape = x.shape
        x_q = _quantize_act(x.reshape(-1, shape[-1]), self.inv)
        y = self._finish(self._product([x_q], 1), x.dtype)
        return y.reshape(*shape[:-1], y.shape[-1])

    def _conv_nchw(self, x_q, groups):
        layer = self.layer
        cols, (oh, ow) = _im2col(x_q, layer.kernel_size, layer.stride,
                                 layer.dilation, groups)
        return self._product(cols, groups), (oh, ow)

    def conv(self, x):
        layer = self.layer
        if layer.padding_mode != 'zeros' or x.dim() != 4:
            return type(layer).forward(layer, x)
        n = x.shape[0]
        t, b, le, r = _conv_pads(layer, x.shape[2], x.shape[3])
        x_q = _quantize_act(x, self.inv)
        if t or b or le or r:
            x_q = F.pad(x_q, (le, r, t, b))
        acc, (oh, ow) = self._conv_nchw(x_q, layer.groups)
        y = self._finish(acc, x.dtype)
        return y.view(n, oh, ow, -1).permute(0, 3, 1, 2)

    def patch(self, x):
        """``PatchEmbed.forward``: NHWC image → ``[N, h·w, C]`` tokens and
        ``(h, w)``."""
        n = x.shape[0]
        x_q = _quantize_act(x, self.inv).permute(0, 3, 1, 2)
        acc, (h, w) = self._conv_nchw(x_q, 1)
        return self._finish(acc, x.dtype).view(n, h * w, -1), (h, w)


def _prepare(entry: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(kernel_q, 1 / x_scale, x_scale · w_scale)`` of a ``'ptq'`` entry,
    each scale formed in float32, as the JAX package forms it."""
    x_scale = entry['x_scale'].float()
    return entry['kernel_q'], 1.0 / x_scale, x_scale * entry['w_scale'].float()


class _Serving:
    """The int8 forwards of ``model``'s layers named in ``table`` (``{name:
    (kernel_q, inv, scale)}``), installed by ``with``.  ``int8_calls``
    counts the layer calls that ran K7; ``fp_layers`` names the quantized
    layers outside the int8 vocabulary, which run in floating point."""

    def __init__(self, model: nn.Module, table: Dict[str, Tuple]):
        sites = _sites(model)
        unknown = sorted(set(table) - set(sites))
        if unknown:
            raise ValueError(f'ptq: no covered layer named {unknown[:5]} in the model')
        self.int8_calls = 0
        self.fp_layers = sorted(n for n in table if sites[n][2] == 'conv'
                                and sites[n][0].padding_mode != 'zeros')
        # K7's unit scales: its float32 result is then the int32 accumulator
        device = next(iter(table.values()))[0].device if table else None
        self.one = torch.ones((1, 1), dtype=torch.float32, device=device)
        self._forwards = {}
        for name, (kernel_q, inv, scale) in table.items():
            layer, site, kind = sites[name]
            int8 = _Int8Layer(layer, site, kind, kernel_q, inv, scale, self)
            self._forwards[site] = getattr(int8, kind)

    def __enter__(self):
        self._ctx = _forwards(self._forwards)
        return self._ctx.__enter__()

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


def _serving(model: nn.Module, qvariables: Dict) -> _Serving:
    if _QCOL not in qvariables:
        raise ValueError("ptq: the serving variables have no 'ptq' entry "
                         '(quantize_convs makes it)')
    return _Serving(model, {n: _prepare(e) for n, e in qvariables[_QCOL].items()})


def ptq_apply(model: nn.Module, qvariables: Dict, *args, **kwargs):
    """``model(*args, **kwargs)`` with its quantized layers in int8 (needs
    :func:`quantize_convs`' output)."""
    with _serving(model, qvariables):
        return model(*args, **kwargs)


def make_ptq_predict_fn(model: nn.Module, qvariables: Dict, **apply_kwargs) -> Callable:
    """Closure ``predict(x)`` for ``tiled_inference``: the int8 forward with
    ``apply_kwargs``, its scales prepared once.  ``predict.serving`` is the
    plan (its ``int8_calls`` and ``fp_layers``)."""
    serving = _serving(model, qvariables)

    def predict(x):
        with serving:
            return model(x, **apply_kwargs)

    predict.serving = serving
    return predict
