"""The T2V multiview video UNet (``UNetSD_T2VBase``) as a PyTorch module.

Port of ``videomv_tpu/models/unet_t2v.py``. The public layout is the JAX
package's: ``forward(x [B, C, F, H, W], t [B], y [B, L, context_dim],
camera_data [B, F, 16]) -> [B, C, F, H, W]`` float32. Inside, activations
are NCHW with frames folded into the batch (``[B·F, C, H, W]``), and the
module computes in the dtype of its parameters (cast the module with
``.to(torch.bfloat16)`` for bf16).

The block plan (``build_unet_plan``) is the JAX package's, so module paths
equal the released checkpoint keys: ``input_blocks.3.op`` (downsample),
``output_blocks.2.1.conv`` (upsample), ``middle_block.0..3``, ``out.0/2``.

``temporal_block`` picks the module of the plan's temporal slots:
``transformer`` (``TemporalTransformer``, the shipped-checkpoint path),
``rotary`` (``TemporalAttentionMultiBlock``: ``temporal_attn_times`` rotary
attentions with the UNet-level ``num_heads``, the ``time_rel_pos_bias``
built once a forward, ``use_sim_mask``, and the forward's ``video_mask`` /
``focus_present_mask``) or ``attemask`` (the causal
``TemporalTransformerAttemask``). ``use_image_dataset`` turns every temporal
block and every ResBlock's temporal convolutions into the identity.

``use_checkpoint`` recomputes every ResBlock and every spatial and temporal
block in the backward pass (the JAX package's ``nn.remat`` per block)
through ``torch.utils.checkpoint`` without reentrancy, which restores the RNG
state, so the recomputed dropout masks are the forward's. ``remat_policy``
is the JAX key: ``full`` keeps only the blocks' inputs; ``dots_no_batch``
also keeps the outputs of the 2-D products (``aten.mm`` / ``addmm``, the
linear layers) and ``dots`` those of the batched ones too (``bmm`` /
``baddbmm``, the plain attention), as ``dots_with_no_batch_dims_saveable`` /
``dots_saveable`` keep ``dot_general``s; everything else, the convolutions
and the custom kernels included, is recomputed. Without autograd recording
(sampling) the blocks run plainly.

Under ``parallel.infer.frame_sharded`` the input holds one rank's block of
the sample's frames (and ``camera_data`` the same block; ``video_mask``
stays whole): every block runs on those frames, and only the temporal ones
(the temporal blocks and each ``ResBlock``'s temporal convolutions) mix
frames, through the collectives of ``parallel.collectives``; the relative
position bias and the causal masks span the sample's frames.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..parallel.infer import current_frame_shard
from .blocks import (
    Downsample,
    GroupNorm,
    NormSiLU,
    RelativePositionBias,
    ResBlock,
    SpatialTransformer,
    TemporalAttentionMultiBlock,
    TemporalTransformer,
    TemporalTransformerAttemask,
    TimestepMLP,
    Upsample,
    sinusoidal_embedding,
    zero_module,
)
from .graphed import GraphedForward, run_forward

__all__ = ["UNetSD_T2VBase", "build_unet_plan"]

_aten = torch.ops.aten
# remat_policy -> the ops whose outputs the backward keeps (None: full remat)
REMAT_SAVED_OPS = {
    "full": None,
    "dots_no_batch": frozenset({_aten.mm.default, _aten.addmm.default}),
    "dots": frozenset({_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                       _aten.baddbmm.default}),
}
TEMPORAL_BLOCKS = ("transformer", "rotary", "attemask")


def _remat_policy(saved, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


def build_unet_plan(
    dim: int,
    dim_mult: Sequence[int],
    num_res_blocks: int,
    attn_scales: Sequence[float],
    temporal_attention: bool = True,
):
    """The encoder/decoder block layout as lists of ``(kind, name,
    channels_in, channels_out)`` entries (a copy of the JAX package's plan,
    reference unet_t2v.py:167-258)."""
    enc_dims = [dim * u for u in [1] + list(dim_mult)]
    dec_dims = [dim * u for u in [dim_mult[-1]] + list(dim_mult)[::-1]]

    enc_entries = []
    shortcut_dims = []
    scale = 1.0

    entry0 = [("conv_in", "input_blocks_0_0", None, dim)]
    if temporal_attention:
        entry0.append(("temporal", "input_blocks_0_1", dim, dim))
    enc_entries.append(entry0)
    shortcut_dims.append(dim)

    idx = 1
    for i, (cin, cout) in enumerate(zip(enc_dims[:-1], enc_dims[1:])):
        for j in range(num_res_blocks):
            entry = [("res", f"input_blocks_{idx}_0", cin, cout)]
            pos = 1
            if scale in attn_scales:
                entry.append(("spatial", f"input_blocks_{idx}_{pos}", cout, cout))
                pos += 1
                if temporal_attention:
                    entry.append(("temporal", f"input_blocks_{idx}_{pos}", cout, cout))
            enc_entries.append(entry)
            shortcut_dims.append(cout)
            cin = cout
            idx += 1
            if i != len(dim_mult) - 1 and j == num_res_blocks - 1:
                enc_entries.append([("down", f"input_blocks_{idx}", cout, cout)])
                shortcut_dims.append(cout)
                scale /= 2.0
                idx += 1

    dec_entries = []
    idx = 0
    for i, (cin, cout) in enumerate(zip(dec_dims[:-1], dec_dims[1:])):
        for j in range(num_res_blocks + 1):
            skip = shortcut_dims.pop()
            entry = [("res", f"output_blocks_{idx}_0", cin + skip, cout)]
            pos = 1
            if scale in attn_scales:
                entry.append(("spatial", f"output_blocks_{idx}_{pos}", cout, cout))
                pos += 1
                if temporal_attention:
                    entry.append(("temporal", f"output_blocks_{idx}_{pos}", cout, cout))
                    pos += 1
            cin = cout
            if i != len(dim_mult) - 1 and j == num_res_blocks:
                entry.append(("up", f"output_blocks_{idx}_{pos}", cout, cout))
                scale *= 2.0
            dec_entries.append(entry)
            idx += 1

    return enc_entries, dec_entries


class UNetSD_T2VBase(nn.Module):
    """Text→multiview 3D video UNet (reference unet_t2v.py:56-523)."""

    def __init__(
        self,
        in_dim: int = 4,
        dim: int = 320,
        y_dim: int = 1024,
        context_dim: int = 1024,
        out_dim: int = 4,
        dim_mult: Sequence[int] = (1, 2, 4, 4),
        num_heads: int = 8,
        head_dim: int = 64,
        camera_dim: int = 16,
        num_res_blocks: int = 2,
        attn_scales: Sequence[float] = (1.0, 0.5, 0.25),
        dropout: float = 0.1,
        temporal_attention: bool = True,
        temporal_block: str = "transformer",
        temporal_attn_times: int = 1,
        use_sim_mask: bool = False,
        use_fps_condition: bool = False,
        use_camera_condition: bool = True,
        use_image_dataset: bool = False,
        use_checkpoint: bool = False,
        remat_policy: str = "full",
        **unused,
    ):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        if remat_policy not in REMAT_SAVED_OPS:
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        self.remat_policy = remat_policy
        if temporal_block not in TEMPORAL_BLOCKS:
            raise ValueError(f"unknown temporal_block {temporal_block!r}")
        self.temporal_block, self.temporal_attn_times = temporal_block, temporal_attn_times
        self.use_sim_mask, self.use_image_dataset = use_sim_mask, use_image_dataset
        self.dim, self.context_dim, self.out_dim = dim, context_dim, out_dim
        self.dim_mult = tuple(dim_mult)
        self.head_dim, self.num_heads, self.camera_dim = head_dim, num_heads, camera_dim
        self.dropout = dropout
        self.temporal_attention = temporal_attention
        self.use_fps_condition = use_fps_condition
        self.use_camera_condition = use_camera_condition
        embed_dim = dim * 4

        if temporal_attention and temporal_block == "rotary":
            # reference unet_t2v.py:163-165: the UNet's num_heads, max_distance 32
            self.time_rel_pos_bias = RelativePositionBias(heads=num_heads, max_distance=32)
        self.time_embed = TimestepMLP(dim, embed_dim)
        if use_fps_condition:
            self.fps_embedding = TimestepMLP(dim, embed_dim, zero_init=True)
        if use_camera_condition:
            self.camera_embedding = TimestepMLP(camera_dim, embed_dim, zero_init=True)

        enc_entries, dec_entries = build_unet_plan(
            dim, self.dim_mult, num_res_blocks, tuple(attn_scales), temporal_attention)
        self.input_blocks = nn.ModuleList()
        for entry in enc_entries:
            if entry[0][0] == "down":  # a bare module: key input_blocks.N.op
                self.input_blocks.append(self._block(in_dim, *entry[0]))
            else:
                self.input_blocks.append(nn.ModuleList(self._block(in_dim, *e) for e in entry))

        mid_ch = dim * self.dim_mult[-1]
        mid = [("res", "middle_block_0", mid_ch, mid_ch),
               ("spatial", "middle_block_1", mid_ch, mid_ch)]
        if temporal_attention:
            mid.append(("temporal", "middle_block_2", mid_ch, mid_ch))
        mid.append(("res", f"middle_block_{len(mid)}", mid_ch, mid_ch))
        self.middle_block = nn.ModuleList(self._block(in_dim, *e) for e in mid)

        self.output_blocks = nn.ModuleList(
            nn.ModuleList(self._block(in_dim, *e) for e in entry) for entry in dec_entries)

        self.out = NormSiLU(GroupNorm(32, dim, eps=1e-5), nn.SiLU(),
                            zero_module(nn.Conv2d(dim, out_dim, 3, padding=1)))
        # the CUDA graphs of a serving pipeline's forward (models/graphed.py)
        self.graphs: Optional[GraphedForward] = None

    def _block(self, in_dim, kind, name, cin, cout):
        if kind == "conv_in":
            return nn.Conv2d(in_dim, cout, 3, padding=1)
        if kind == "res":
            return ResBlock(cin, self.dim * 4, self.dropout, cout, self.use_image_dataset)
        if kind == "spatial":
            return SpatialTransformer(cout, cout // self.head_dim, self.head_dim, depth=1,
                                      context_dim=self.context_dim)
        if kind == "temporal" and self.temporal_block == "rotary":
            # the UNet-level num_heads in every block (reference
            # unet_t2v.py:175,194,225,250), which takes dim // heads per head
            return TemporalAttentionMultiBlock(
                cout, self.num_heads, min(32, self.head_dim), self.temporal_attn_times,
                self.use_image_dataset, self.use_sim_mask)
        if kind == "temporal":
            # the init block (dim -> 512 inner) keeps the configured num_heads;
            # every later one uses cout // head_dim (reference unet_t2v.py:172,191)
            n_heads = self.num_heads if name == "input_blocks_0_1" else cout // self.head_dim
            cls = (TemporalTransformerAttemask if self.temporal_block == "attemask"
                   else TemporalTransformer)
            return cls(cout, n_heads, self.head_dim, depth=1,
                       multiply_zero=self.use_image_dataset)
        if kind == "down":
            return Downsample(cout)
        if kind == "up":
            return Upsample(cout)
        raise ValueError(kind)

    @property
    def dtype(self) -> torch.dtype:
        return self.out[2].weight.dtype

    def fsdp_units(self) -> List[nn.Module]:
        """The modules the forward calls as a whole, one FSDP unit each
        (``parallel.mesh.apply_fsdp``): every block of the encoder, the
        middle and the decoder, the embedding MLPs and the output head."""
        units: List[nn.Module] = []
        for blocks in list(self.input_blocks) + [self.middle_block] + list(self.output_blocks):
            units.extend(blocks if isinstance(blocks, nn.ModuleList) else [blocks])
        units.append(self.time_embed)
        units.extend(getattr(self, n) for n in ("fps_embedding", "camera_embedding",
                                                 "time_rel_pos_bias") if hasattr(self, n))
        units.append(self.out)
        return units

    def _block_call(self, mod: nn.Module, *args):
        """``mod(*args)``, recomputed in the backward pass under
        ``remat_policy`` when ``use_checkpoint`` is set and autograd is
        recording."""
        if not (self.use_checkpoint and torch.is_grad_enabled()):
            return mod(*args)
        saved = REMAT_SAVED_OPS[self.remat_policy]
        if saved is None:
            return checkpoint(mod, *args, use_reentrant=False)
        return checkpoint(mod, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, functools.partial(_remat_policy, saved)))

    def _run(self, blocks, h, e, context, b, f, temporal_args=()):
        for mod in (blocks if isinstance(blocks, nn.ModuleList) else (blocks,)):
            if isinstance(mod, ResBlock):
                h = self._block_call(mod, h, e, f)
            elif isinstance(mod, SpatialTransformer):
                h = self._block_call(mod, h, context)
            elif isinstance(mod, (TemporalTransformer, TemporalAttentionMultiBlock)):
                bf, c, hh, ww = h.shape
                args = temporal_args if isinstance(mod, TemporalAttentionMultiBlock) else ()
                ht = self._block_call(
                    mod, h.reshape(b, f, c, hh, ww).permute(0, 2, 1, 3, 4), *args)
                h = ht.permute(0, 2, 1, 3, 4).reshape(bf, c, hh, ww)
            else:
                h = mod(h)
        return h

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        y: Optional[torch.Tensor] = None,
        camera_data: Optional[torch.Tensor] = None,
        fps: Optional[torch.Tensor] = None,
        zero_y: Optional[torch.Tensor] = None,
        video_mask: Optional[torch.Tensor] = None,
        focus_present_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``y=None`` conditions every row on the first token of ``zero_y``
        [B or 1, L, context_dim]. ``video_mask`` [B, F] (the sample's frames,
        whole under frame sharding) and ``focus_present_mask`` [B] reach the
        rotary temporal blocks only. Replayed as a CUDA graph where
        ``self.graphs`` engages (``models/graphed.py``)."""
        return run_forward(self, self._forward, x=x, t=t, y=y, camera_data=camera_data, fps=fps,
                           zero_y=zero_y, video_mask=video_mask,
                           focus_present_mask=focus_present_mask)

    def _forward(self, x, t, y, camera_data, fps, zero_y, video_mask, focus_present_mask):
        b, c, f, hh, ww = x.shape
        dt = self.dtype

        temporal_args = ()
        if hasattr(self, "time_rel_pos_bias"):
            # over the sample's frames, once a forward
            shard = current_frame_shard()
            pos_bias = self.time_rel_pos_bias(f if shard is None else shard.frames, x.device)
            temporal_args = (pos_bias, focus_present_mask, video_mask)

        e = self.time_embed(sinusoidal_embedding(t, self.dim).to(dt))
        if self.use_fps_condition and fps is not None:
            e = e + self.fps_embedding(sinusoidal_embedding(fps, self.dim).to(dt))
        e = e.repeat_interleave(f, dim=0)  # [B·F, E]
        if self.use_camera_condition and camera_data is not None:
            e = e + self.camera_embedding(camera_data.reshape(b * f, self.camera_dim).to(dt))

        if y is None:
            if zero_y is None:
                raise ValueError("UNetSD_T2VBase needs y or zero_y")
            y = zero_y[:, :1].expand(b, 1, self.context_dim)
        context = y.to(dt).repeat_interleave(f, dim=0)  # [B·F, L, C_ctx]

        h = x.permute(0, 2, 1, 3, 4).reshape(b * f, c, hh, ww).to(dt)
        xs = []
        for blocks in self.input_blocks:
            h = self._run(blocks, h, e, context, b, f, temporal_args)
            xs.append(h)
        h = self._run(self.middle_block, h, e, context, b, f, temporal_args)
        for blocks in self.output_blocks:
            h = self._run(blocks, torch.cat([h, xs.pop()], dim=1), e, context, b, f,
                          temporal_args)
        h = self.out(h)
        return h.reshape(b, f, self.out_dim, hh, ww).permute(0, 2, 1, 3, 4).float()
