"""Exact ring attention: sequence-parallel multi-head attention over a group.

The JAX package's ``ops/ring_attention.py`` (context parallelism, beyond the
reference): the sequence axis is sharded over the ranks of a group, each
rank keeps its query chunk, and the k / v chunks rotate around the ring
(``batch_isend_irecv`` to the next rank, from the previous) while an
online-softmax update accumulates exact attention in fp32 — the same
softmax(QK^T)V as the dense kernel, with n - 1 hops of the local k / v chunk
a layer.  The ring is plain PyTorch: its products are ``einsum`` work, which
the JAX package leaves to XLA too (no Pallas).

Torch's point-to-point calls carry no gradient, so ``ring_mha`` is an
autograd function whose backward is a second ring: dq stays with its query
chunk, dk and dv travel with their k / v chunk and take one last hop home.

``cp_trunk_forward`` runs the model's own inter-modality trunk
(``models.vit.Transformer``: pre-LN blocks + final LN) on activations
sharded over the sequence, reading its parameters where they are (no copy,
so its gradients land on the trunk's parameters).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from maestro_tpu_torch.models.vit import dense, layer_norm


def _ring(group) -> tuple[int, int, int, int]:
    """(size, rank, next global rank, previous global rank) of ``group``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return (n, r, dist.get_global_rank(group, (r + 1) % n),
            dist.get_global_rank(group, (r - 1) % n))


def _rotate(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Send each tensor to the next rank of the ring; returns what the
    previous rank sent."""
    _, _, nxt, prv = _ring(group)
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _accumulate(qf, kc, vc, o, m, l, sm_scale: float):
    """Fold one k / v chunk into the online softmax (fp32 statistics)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float()) * sm_scale
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    o = o * corr.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, vc.float())
    return o, m_new, l


class _RingMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, sm_scale):
        n = dist.get_world_size(group)
        b, lc, h, d = q.shape
        qf = q.float()
        o = torch.zeros((b, lc, h, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, lc), -torch.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, lc), dtype=torch.float32, device=q.device)
        kc, vc = k, v
        # n - 1 rotate-and-accumulate hops, then the last chunk folds in
        for _ in range(n - 1):
            o, m, l = _accumulate(qf, kc, vc, o, m, l, sm_scale)
            kc, vc = _rotate([kc, vc], group)
        o, m, l = _accumulate(qf, kc, vc, o, m, l, sm_scale)
        out = o / l.transpose(1, 2)[..., None]
        lse = m + torch.log(l)  # [B, H, Lc]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.sm_scale = group, sm_scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.sm_scale
        n = dist.get_world_size(group)
        qf, do = q.float(), dout.float()
        delta = (do * out).sum(dim=-1).transpose(1, 2)  # [B, H, Lc]
        dq = torch.zeros_like(qf)
        kc, vc = k, v
        dk, dv = torch.zeros_like(qf), torch.zeros_like(qf)

        def chunk_grads(kc, vc, dk, dv):
            kf, vf = kc.float(), vc.float()
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
            p = torch.exp(s - lse[..., None])
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, do)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
            ds = p * (dp - delta[..., None]) * scale
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf)
            return torch.einsum("bhqk,bkhd->bqhd", ds, kf), dk, dv

        # dq stays here; dk and dv travel with their chunk
        for _ in range(n - 1):
            g, dk, dv = chunk_grads(kc, vc, dk, dv)
            dq = dq + g
            kc, vc, dk, dv = _rotate([kc, vc, dk, dv], group)
        g, dk, dv = chunk_grads(kc, vc, dk, dv)
        dq = dq + g
        if n > 1:  # the chunk's gradients take their last hop home
            dk, dv = _rotate([dk, dv], group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
             sm_scale: float | None = None) -> torch.Tensor:
    """Exact attention of this rank's query chunk ``q`` ``[B, Lc, H, D]``
    over the whole sequence, whose k / v chunks the ranks of ``group`` (the
    default group if None) hold in rank order; differentiable in q, k, v."""
    group = group if group is not None else dist.group.WORLD
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    return _RingMHA.apply(q, k, v, group, scale)


def _block(block, x: torch.Tensor, group) -> torch.Tensor:
    """One pre-LN ``models.vit.Block`` with its attention over the ring."""
    attn = block.attn
    b, lc, _ = x.shape
    y = layer_norm(x, attn.norm, attn.dtype)
    qkv = dense(y, attn.qkv, attn.dtype).view(b, lc, 3, attn.heads, attn.dim_head)
    out = ring_mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], group, attn.dim_head**-0.5)
    x = x + dense(out.reshape(b, lc, -1), attn.out, attn.dtype)
    return x + block.mlp(x)  # the MLP is per token: it runs on the chunk as it is


def cp_trunk_forward(trunk, x: torch.Tensor, group=None) -> torch.Tensor:
    """The trunk ``trunk`` (a ``models.vit.Transformer``, e.g. a MAE's
    ``encoder_inter``) on this rank's chunk ``x`` ``[B, Lc, E]`` of a
    sequence sharded over ``group`` in rank order; returns the output chunk.
    The trunk's own parameters are used, so its gradients land on them
    (each rank's part: the caller sums them over the group)."""
    group = group if group is not None else dist.group.WORLD
    for i in range(trunk.depth):
        x = _block(getattr(trunk, f"block{i}"), x, group)
    return layer_norm(x, trunk.norm, trunk.dtype)
