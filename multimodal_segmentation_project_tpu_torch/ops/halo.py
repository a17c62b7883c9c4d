"""The D-axis halo exchange for 3x3x3 convs on a spatial mesh.

Port of ``multimodal_segmentation_project_tpu/ops/halo.py`` without the
shard_map: each rank holds a plain (B, C, Dl, H, W) slab of the volume's D
axis (``parallel/mesh.py``), and a SAME 3x3x3 conv needs one plane of each
neighbour's. :func:`exchange_halo_d` sends this rank's first plane to the
previous rank of its spatial group and its last plane to the next, and
attaches what it receives: (B, C, Dl + 2, H, W), with zeros at the
volume's two ends (the conv's SAME padding). :func:`halo_conv3` runs the
unmodified conv on that slab and slices off its two edge planes, as the
JAX package does: 2 / Dl more planes per conv, and no new kernel.

The backward of the exchange is a send, not a sum: each halo plane's
cotangent goes back to the rank that owns the plane and is added to that
plane's. The planes travel by ``dist.batch_isend_irecv`` inside the spatial
group: card to card under NCCL; through host memory under gloo, which has
no point-to-point on CUDA tensors. ``exchange_halo_d.bytes_sent`` counts the
bytes this rank sends, forward and backward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from multimodal_segmentation_project_tpu_torch.parallel.mesh import Mesh, _staged


def _swap_planes(mesh: Mesh, to_prev: torch.Tensor, to_next: torch.Tensor):
    """Send ``to_prev`` to the previous rank of the spatial group and
    ``to_next`` to the next; return (from the previous, from the next),
    zeros where this rank is at an end of the volume. Every plane is a
    contiguous (B, C, H, W) tensor."""
    s, n = mesh.spatial_index, mesh.n_spatial
    group = mesh.spatial_group
    stage = _staged(to_prev, group, "p2p")
    from_prev, from_next = torch.zeros_like(to_prev), torch.zeros_like(to_next)
    bufs = {}
    ops = []
    for peer_s, send, recv, key in ((s - 1, to_prev, from_prev, "prev"),
                                    (s + 1, to_next, from_next, "next")):
        if not 0 <= peer_s < n:
            continue
        peer = mesh.global_rank(mesh.data_index, peer_s)
        exchange_halo_d.bytes_sent += send.numel() * send.element_size()
        send_t = send.cpu() if stage else send
        recv_t = torch.empty(recv.shape, dtype=recv.dtype) if stage else recv
        bufs[key] = (send_t, recv_t, recv)
        ops += [dist.P2POp(dist.isend, send_t, peer, group),
                dist.P2POp(dist.irecv, recv_t, peer, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if stage:
        for _, recv_t, recv in bufs.values():
            recv.copy_(recv_t)
    return from_prev, from_next


class _HaloD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        from_prev, from_next = _swap_planes(mesh, x[:, :, 0].contiguous(),
                                            x[:, :, -1].contiguous())
        return torch.cat([from_prev.unsqueeze(2), x, from_next.unsqueeze(2)], dim=2)

    @staticmethod
    def backward(ctx, g):
        # the first halo plane is the previous rank's last plane, the last
        # halo plane the next rank's first: their cotangents go home
        to_prev, to_next = g[:, :, 0].contiguous(), g[:, :, -1].contiguous()
        from_prev, from_next = _swap_planes(ctx.mesh, to_prev, to_next)
        dx = g[:, :, 1:-1].clone()
        dx[:, :, 0] += from_prev
        dx[:, :, -1] += from_next
        return dx, None


def exchange_halo_d(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(B, C, Dl, H, W) slab -> (B, C, Dl + 2, H, W) with the neighbours'
    edge planes attached (zeros at the volume's ends); differentiable."""
    return _HaloD.apply(x, mesh)


exchange_halo_d.bytes_sent = 0


def halo_conv3(conv_fn, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               mesh: Mesh) -> torch.Tensor:
    """``conv_fn(x, w, b)`` (a SAME 3x3x3 channel-first conv, its epilogue
    per voxel) of this rank's D slab of the volume: exchange the halo, run
    ``conv_fn`` on the (Dl + 2)-plane slab, drop its two edge planes."""
    return conv_fn(exchange_halo_d(x, mesh), w, b)[:, :, 1:-1]
