"""Fused softmax cross-entropy head: the loss without materialising the
[T, V] logits -- the port of ``triton_kubernetes_tpu/ops/fused_ce.py``.

The vocab projection runs in chunks of ``chunk`` columns with an online
logsumexp in f32, so peak memory is ``[T, chunk]`` instead of ``[T, V]``;
the backward recomputes each chunk's logits and accumulates dH and dW
chunk by chunk. As in the reference this is plain tensor code, no kernel:
the products go to ``torch.mm``.

Numerics follow the reference step for step: each chunk's logits are the
product of the input-dtype operands accumulated in f32 and kept in f32;
the running max, sum and target logit are f32; ``loss = m + log(s) -
logit[target]``. The backward keeps the f32 cotangent ``(p - onehot) * g``
in both contractions (only ``h`` and ``w`` are input-dtype operands, taken
exactly into f32), then rounds dH and dW to the input dtypes.

When the chunk does not divide the vocab, the last chunk is padded with
zero columns whose logits are masked to ``-inf`` (and whose softmax mass
is zeroed in the backward), as in the reference; only that chunk is
padded, and only it pays for the mask.
"""

from __future__ import annotations

import torch

DEFAULT_CHUNK = 8192


def _chunks(w: torch.Tensor, chunk: int):
    """(start, [D, chunk] operand, padded) for each vocab chunk; the last
    is zero-padded to ``chunk`` columns when the chunk does not divide V."""
    if chunk < 1:
        raise ValueError(f"ce_chunk must be >= 1, got {chunk}")
    v = w.shape[1]
    for start in range(0, v, chunk):
        wc = w[:, start:start + chunk]
        padded = wc.shape[1] < chunk
        if padded:
            wc = torch.nn.functional.pad(wc, (0, chunk - wc.shape[1]))
        yield start, wc, padded


def _logits(h: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """[T, C] f32 logits: the product of the input-dtype operands,
    accumulated in f32 and never rounded to the input dtype."""
    if h.dtype == torch.float32:
        return h @ wc
    if h.is_cuda:
        return torch.mm(h, wc, out_dtype=torch.float32)
    return h.float() @ wc.float()


class _FusedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, w, targets, chunk: int):
        t = h.shape[0]
        v = w.shape[1]
        m = torch.full((t,), float("-inf"), device=h.device)
        s = torch.zeros((t,), device=h.device)
        tgt = torch.zeros((t,), device=h.device)
        cols = torch.arange(chunk, device=h.device)
        for start, wc, padded in _chunks(w, chunk):
            logits = _logits(h, wc.to(h.dtype))
            if padded:  # padded vocab columns must not contribute
                logits = torch.where((start + cols)[None, :] < v, logits,
                                     float("-inf"))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            in_chunk = (targets >= start) & (targets < start + chunk)
            idx = (targets - start).clamp(0, chunk - 1)
            tgt = tgt + torch.where(
                in_chunk, logits.gather(1, idx[:, None])[:, 0],
                torch.zeros((), device=h.device))
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(h, w, targets, lse)
        ctx.chunk = chunk
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        h, w, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        v = w.shape[1]
        hf = h.float()
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
        cols = torch.arange(chunk, device=h.device)
        for start, wc, padded in _chunks(w, chunk):
            wc = wc.to(h.dtype)
            p = torch.exp(_logits(h, wc) - lse[:, None])
            if padded:  # zero the padded columns' softmax mass
                p = torch.where((start + cols)[None, :] < v, p, 0.0)
            in_chunk = (targets >= start) & (targets < start + chunk)
            idx = (targets - start).clamp(0, chunk - 1)
            onehot = (cols[None, :] == idx[:, None]) & in_chunk[:, None]
            dlogits = (p - onehot.float()) * g[:, None]  # [T, C] f32
            dh += dlogits @ wc.float().t()
            dw_chunk = hf.t() @ dlogits  # [D, C] f32
            width = min(chunk, v - start)
            dw[:, start:start + width] = dw_chunk[:, :width].to(w.dtype)
        return dh.to(h.dtype), dw, None, None


def fused_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                        targets: torch.Tensor,
                        chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Per-token CE loss [T] (f32) for hidden states h [T, D], head w
    [D, V] and integer targets [T]."""
    return _FusedCrossEntropy.apply(h, w, targets.long(), chunk)


def cross_entropy_with_integer_labels(logits: torch.Tensor,
                                      targets: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy_with_integer_labels``: per-position
    ``logsumexp(logits) - logits[target]`` in f32, shape of ``targets``."""
    lf = logits.float()
    tgt = lf.gather(-1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(lf, dim=-1) - tgt
