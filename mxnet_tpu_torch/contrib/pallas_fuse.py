"""Pair-fusion inference rewrite for bottleneck ResNets (counterpart of
``mxnet_tpu/contrib/pallas_fuse.py``, whose name it keeps).

``fuse_resnet_v1(net)`` takes a model-zoo ``ResNetV1`` with bottleneck
blocks and returns :class:`FusedResNetV1`, an inference module that

* runs the whole trunk channels-last (NHWC), so the 1x1 convolutions are
  matrix products over (B*H*W, C) rows;
* folds every BatchNorm into a per-channel affine ``y = x*s + b`` with
  ``s = gamma / sqrt(var + eps)``;
* with ``use_pallas=True`` sends every block boundary
  (``c3 -> bn3 -> +skip -> relu -> next c1 -> bn1 -> relu``) to ONE launch
  of the fused 1x1-pair kernel (``ops.hopper.conv1x1.conv1x1_pair(...,
  residual=..., return_mid=True)``); with ``use_pallas=False`` the same
  folded NHWC graph leaves the boundary to two library matrix products and
  elementwise ops, the yardstick the kernel is measured against;
* leaves the 3x3s, the strided block entries and the stem to library calls
  (cuDNN convolutions and ``torch.matmul``).

The forward translates the JAX package's ``_forward`` and ``_stage`` line
for line, in the working dtype (bf16 by default) with every weight and
affine cast to it, and returns f32 logits. The NHWC tensors are never
copied to NCHW: a convolution sees ``x.permute(0, 3, 1, 2)`` (a
channels-last NCHW view) with a channels-last weight, and its
channels-last output is permuted back. The JAX package measured the kernel
arm losing end to end on a TPU v5e; on the GPU that is measured anew
(``chip_smoke.py``), not assumed.

Training is not rewritten: training-mode BatchNorm computes batch
statistics between the convolutions, which breaks the single-pass fusion.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..base import MXNetError
from ..gluon import nn as gnn
from ..ops import nn as _ops
from ..ops.hopper.conv1x1 import conv1x1_pair


def _fold_bn(bn):
    """Inference BN as (scale, bias) f32: y = x*scale + bias."""
    var = bn.running_var.detach().to(torch.float32)
    gamma = (bn.weight.detach().to(torch.float32) if bn.weight is not None
             else torch.ones_like(var))
    s = gamma / torch.sqrt(var + bn.eps)
    beta = bn.bias.detach().to(torch.float32)
    return s, beta - bn.running_mean.detach().to(torch.float32) * s


def _conv_w(conv):
    """Conv2D weight (O, I, kh, kw) -> HWIO, the JAX package's layout."""
    return conv.weight.detach().permute(2, 3, 1, 0)


def _extract_bottleneck(blk):
    """Pull (weights, affines, stride, downsample) out of a BottleneckV1."""
    body = blk.body
    p = {
        "w1": _conv_w(body[0])[0, 0],          # (I, mid) 1x1
        "a1": _fold_bn(body[1]),
        "w2": _conv_w(body[3]),                # (3, 3, mid, mid)
        "a2": _fold_bn(body[4]),
        "w3": _conv_w(body[6])[0, 0],          # (mid, O) 1x1
        "a3": _fold_bn(body[7]),
        "stride": body[0]._strides[0],
    }
    if blk.downsample is not None:
        p["wd"] = _conv_w(blk.downsample[0])[0, 0]
        p["ad"] = _fold_bn(blk.downsample[1])
    return p


class FusedResNetV1(nn.Module):
    """Inference module produced by :func:`fuse_resnet_v1`.

    Holds its weights as buffers in the working dtype: 1x1 weights as
    contiguous (I, O) matrices, 3x3 and stem weights as channels-last OIHW
    tensors for cuDNN, affines as (C,) vectors. ``forward`` takes an NCHW
    image batch and returns (B, classes) f32 logits.
    """

    def __init__(self, stem, stages, head, dtype, use_pallas=True):
        super().__init__()
        self._dtype = dtype
        self._use_pallas = use_pallas
        self._n = 0

        def buf(t):  # cast_tree: every tensor to the working dtype
            name = f"t{self._n}"
            self._n += 1
            self.register_buffer(name, t.to(dtype).contiguous(),
                                 persistent=False)
            return name

        def conv_buf(w_hwio):  # HWIO -> OIHW, laid out channels-last
            name = f"t{self._n}"
            self._n += 1
            self.register_buffer(
                name, w_hwio.permute(3, 2, 0, 1).to(dtype).contiguous(
                    memory_format=torch.channels_last), persistent=False)
            return name

        def affine(a):
            return (buf(a[0]), buf(a[1]))

        self._stem = {"w": conv_buf(stem["w"]), "a": affine(stem["a"])}
        self._stages = []
        for blocks in stages:
            names = []
            for p in blocks:
                q = {"w1": buf(p["w1"]), "a1": affine(p["a1"]),
                     "w2": conv_buf(p["w2"]), "a2": affine(p["a2"]),
                     "w3": buf(p["w3"]), "a3": affine(p["a3"]),
                     "stride": p["stride"]}
                if "wd" in p:
                    q["wd"] = buf(p["wd"])
                    q["ad"] = affine(p["ad"])
                names.append(q)
            self._stages.append(names)
        self._head = {"w": buf(head["w"]), "b": buf(head["b"])}

    def _t(self, name):
        return getattr(self, name)

    def _a(self, names):
        return self._t(names[0]), self._t(names[1])

    # -- the forward, as the JAX package's ----------------------------------

    @staticmethod
    def _affine_relu(x, a, relu=True):
        s, b = a
        y = x * s + b
        return torch.relu(y).to(x.dtype) if relu else y.to(x.dtype)

    @staticmethod
    def _conv(x, w, stride=1, pad=None):
        """NHWC ``x`` through a channels-last OIHW weight; NHWC out."""
        k = w.shape[-1]
        if pad is None:
            pad = (k - 1) // 2
        y = _ops.convolution(x.permute(0, 3, 1, 2), w, None, stride, pad)
        return y.permute(0, 2, 3, 1)

    def _stage(self, x, blocks):
        """x NHWC; bottleneck stage with pair-fused block boundaries."""
        b0 = blocks[0]
        st = b0["stride"]
        xs = x[:, ::st, ::st, :] if st > 1 else x
        if "wd" in b0:
            res = self._affine_relu(xs @ self._t(b0["wd"]),
                                    self._a(b0["ad"]), relu=False)
        else:
            res = x
        h = self._affine_relu(xs @ self._t(b0["w1"]), self._a(b0["a1"]))
        h = self._affine_relu(self._conv(h, self._t(b0["w2"])),
                              self._a(b0["a2"]))
        for i, blk in enumerate(blocks):
            s3, b3 = self._a(blk["a3"])
            w3 = self._t(blk["w3"])
            if i + 1 < len(blocks):
                nxt = blocks[i + 1]
                s1n, b1n = self._a(nxt["a1"])
                w1n = self._t(nxt["w1"])
                if self._use_pallas:
                    # boundary pair in ONE kernel; mid = this block's
                    # output = the next boundary's residual
                    h2, res2 = conv1x1_pair(
                        h, w3, w1n, s3, b3, s1n, b1n, residual=res,
                        return_mid=True)
                else:
                    # yardstick arm: identical folded NHWC graph, the
                    # boundary left to library products and elementwise ops
                    y = self._affine_relu(h @ w3, (s3, b3), relu=False)
                    res2 = torch.relu(y + res).to(h.dtype)
                    h2 = self._affine_relu(res2 @ w1n, (s1n, b1n))
                res = res2
                h = self._affine_relu(self._conv(h2, self._t(nxt["w2"])),
                                      self._a(nxt["a2"]))
            else:
                y = self._affine_relu(h @ w3, (s3, b3), relu=False)
                h = torch.relu(y + res).to(x.dtype)
        return h

    def forward(self, x):
        x = x.to(self._dtype).permute(0, 2, 3, 1).contiguous()  # -> NHWC
        x = self._conv(x, self._t(self._stem["w"]), stride=2, pad=3)
        x = self._affine_relu(x, self._a(self._stem["a"]))
        # reduce_window(max, 3x3, stride 2, pad 1) with a -inf init
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for blocks in self._stages:
            x = self._stage(x, blocks)
        x = torch.mean(x, dim=(1, 2)).to(self._dtype)
        return (x @ self._t(self._head["w"])
                + self._t(self._head["b"])).to(torch.float32)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def fuse_resnet_v1(net, dtype="bfloat16", block_rows=512, use_pallas=False):
    """Fuse a bottleneck ``ResNetV1`` for inference; the module lives on
    the device of ``net``'s weights.

    Requires the v1 deep-stem layout (7x7 stem; ``BottleneckV1`` stages).
    Raises MXNetError for basic-block, v2 and thumbnail models: the pair
    motif this fuses only exists in bottleneck nets. ``use_pallas=True``
    routes every block boundary through the fused 1x1-pair kernel;
    ``block_rows`` is the reference's and is ignored: the kernel picks its
    own row tile.
    """
    torch_dtype = _DTYPES.get(str(dtype).replace("torch.", ""))
    if torch_dtype is None:
        raise MXNetError(f"fuse_resnet_v1: dtype {dtype!r} not in "
                         f"{sorted(_DTYPES)}")
    feats = list(net.features)
    if len(feats) != 9:
        raise MXNetError(
            "fuse_resnet_v1 expects the model-zoo ResNetV1 bottleneck "
            f"layout (9 feature blocks, got {len(feats)}); thumbnail "
            "and v2 variants are not fusable")
    if not isinstance(feats[0], gnn.Conv2D) or \
            not isinstance(feats[1], gnn.BatchNorm):
        raise MXNetError("fuse_resnet_v1 expects a 7x7 conv + BatchNorm "
                         "stem (ResNetV1)")
    stem = {"w": _conv_w(feats[0]), "a": _fold_bn(feats[1])}
    stages = []
    for stage in feats[4:8]:
        blocks = list(stage)
        if not hasattr(blocks[0], "body") or len(list(blocks[0].body)) != 8:
            raise MXNetError(
                "fuse_resnet_v1 supports BottleneckV1 stages only")
        stages.append([_extract_bottleneck(b) for b in blocks])
    head = {"w": net.output.weight.detach().T, "b": net.output.bias.detach()}
    del block_rows
    return FusedResNetV1(stem, stages, head, torch_dtype,
                         use_pallas=use_pallas).eval()
