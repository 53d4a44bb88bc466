"""The composable LM stack (``repro.models.transformer.LM``).

A model is a list of groups, each a superblock repeated ``reps`` times;
parameters and caches keep the JAX package's tree (``{"embed", "groups",
"final_norm"}``, every group's leaves stacked with a leading ``reps``
dimension), so both cross between the packages as plain leaves
(``convert.from_leaves``). Where JAX lowers each group as one ``lax.scan``
(rematerialised by ``jax.checkpoint`` for training), the port loops over
``reps`` in Python and applies the blocks to views of the stacked leaves.

Ported: dense decoders of global attention with SwiGLU / GeGLU / GELU FF
(phi4-mini) and xLSTM stacks (xlstm-1.3b). MoE, RG-LRU, sliding-window and
cross attention, and the audio and VLM families raise
``NotImplementedError`` (ROADMAP.md §A3).

API: ``param_defs()`` / ``init(seed, device)`` / ``cache_defs(batch,
max_len)`` / ``init_cache(batch, max_len, device)``;
``prefill(params, cache, batch) -> (last_logits, cache)``;
``decode_step(params, cache, batch, pos) -> (logits, cache)``;
``train_loss(params, batch) -> (loss, metrics)``, differentiable by
autograd (attention's B7 through ``kernels.flash_attention.
FlashAttention``). Caches are filled in place and returned.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models import params as pdefs
from repro_torch.models.attention import attn_apply, attn_defs
from repro_torch.models.attention import cache_defs as attn_cache_defs
from repro_torch.models.config import ArchConfig, BlockSpec, FF, Mixer
from repro_torch.models.layers import (chunked_softmax_xent, embed_apply,
                                       embed_defs, ff_apply, ff_defs,
                                       norm_apply, norm_defs, unembed_apply)
from repro_torch.models.xlstm import (mlstm_apply, mlstm_cache_defs,
                                      mlstm_defs, slstm_apply,
                                      slstm_cache_defs, slstm_defs)

PyTree = Any

_PORTED_FAMILIES = ("dense", "ssm")
_PORTED_MIXERS = (Mixer.GLOBAL_ATTN, Mixer.MLSTM, Mixer.SLSTM)


def _refuse(cfg: ArchConfig) -> None:
    """Raise for what the port does not take yet (ROADMAP.md §A3)."""
    what = []
    if cfg.family not in _PORTED_FAMILIES:
        what.append(f"family {cfg.family!r}")
    if cfg.moe is not None or cfg.encoder is not None or cfg.prefix_lm:
        what.append("MoE / encoder / prefix-LM settings")
    for sb, _ in cfg.groups:
        for spec in sb:
            if spec.mixer not in _PORTED_MIXERS:
                what.append(f"mixer {spec.mixer.value}")
            if spec.ff is FF.MOE:
                what.append("MoE FF")
    if what:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(sorted(set(what)))} not ported yet "
            f"(ROADMAP.md §A3)")


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ArchConfig

    def __post_init__(self):
        _refuse(self.cfg)

    # ---- parameter declaration ------------------------------------------------

    def _block_defs(self, spec: BlockSpec) -> PyTree:
        cfg = self.cfg
        d: dict[str, Any] = {"norm1": norm_defs(cfg)}
        if spec.mixer is Mixer.GLOBAL_ATTN:
            d["mixer"] = attn_defs(cfg)
        elif spec.mixer is Mixer.MLSTM:
            d["mixer"] = mlstm_defs(cfg)
        else:
            d["mixer"] = slstm_defs(cfg)
        if spec.ff is not FF.NONE:
            d["norm2"] = norm_defs(cfg)
            d["ff"] = ff_defs(cfg, spec.ff)
        return d

    def _superblock_defs(self, superblock: tuple[BlockSpec, ...]) -> PyTree:
        return {f"b{i}": self._block_defs(s) for i, s in enumerate(superblock)}

    def param_defs(self) -> PyTree:
        cfg = self.cfg
        return {
            "embed": embed_defs(cfg),
            "groups": [pdefs.stack(self._superblock_defs(sb), reps)
                       for sb, reps in cfg.groups],
            "final_norm": norm_defs(cfg),
        }

    def init(self, seed: int, device="cpu") -> PyTree:
        return pdefs.materialize(self.param_defs(), seed, device)

    def n_params(self) -> int:
        return pdefs.count_params(self.param_defs())

    # ---- caches -----------------------------------------------------------------

    def _block_cache_defs(self, spec: BlockSpec, batch: int,
                          max_len: int) -> PyTree:
        if spec.mixer is Mixer.GLOBAL_ATTN:
            return attn_cache_defs(self.cfg, spec, batch, max_len)
        if spec.mixer is Mixer.MLSTM:
            return mlstm_cache_defs(self.cfg, batch)
        return slstm_cache_defs(self.cfg, batch)

    def cache_defs(self, batch: int, max_len: int) -> PyTree:
        return {"groups": [
            {f"b{i}": pdefs.stack(self._block_cache_defs(s, batch, max_len),
                                  reps)
             for i, s in enumerate(sb)}
            for sb, reps in self.cfg.groups]}

    def init_cache(self, batch: int, max_len: int, device="cpu") -> PyTree:
        return pdefs.zeros(self.cache_defs(batch, max_len), device)

    # ---- block application --------------------------------------------------------

    def _apply_block(self, spec: BlockSpec, p: PyTree, x: torch.Tensor,
                     cache: Optional[PyTree], *, decode_pos: Optional[int],
                     causal: bool = True) -> torch.Tensor:
        cfg = self.cfg
        h = norm_apply(cfg, p["norm1"], x)
        if spec.mixer is Mixer.GLOBAL_ATTN:
            mixed, _ = attn_apply(cfg, spec, p["mixer"], h, cache=cache,
                                  decode_pos=decode_pos, causal=causal)
        elif spec.mixer is Mixer.MLSTM:
            mixed, _ = mlstm_apply(cfg, p["mixer"], h, cache,
                                   decode=decode_pos is not None)
        else:
            mixed, _ = slstm_apply(cfg, p["mixer"], h, cache,
                                   decode=decode_pos is not None)
        x = x + mixed
        if spec.ff is not FF.NONE:
            x = x + ff_apply(cfg, spec.ff, p["ff"], norm_apply(cfg, p["norm2"],
                                                               x))
        return x

    def _run_group(self, superblock: tuple[BlockSpec, ...], reps: int,
                   group_params: PyTree, x: torch.Tensor,
                   group_cache: Optional[PyTree], **kw) -> torch.Tensor:
        """``reps`` copies of the superblock over the residual stream; rep
        ``r`` reads row ``r`` of every stacked leaf (views, so the caches
        fill in place)."""
        for rep in range(reps):
            for i, spec in enumerate(superblock):
                key = f"b{i}"
                p = _row(group_params[key], rep)
                c = (_row(group_cache[key], rep) if group_cache is not None
                     else None)
                x = self._apply_block(spec, p, x, c, **kw)
        return x

    # ---- full forward ---------------------------------------------------------------

    def forward(self, params: PyTree, tokens: torch.Tensor, *,
                cache: Optional[PyTree] = None,
                decode_pos: Optional[int] = None) -> torch.Tensor:
        """Hidden states (B, S, d) after the final norm; ``cache`` (when
        given) is filled in place."""
        cfg = self.cfg
        x = embed_apply(cfg, params["embed"], tokens)
        for gi, (sb, reps) in enumerate(cfg.groups):
            gc = cache["groups"][gi] if cache is not None else None
            x = self._run_group(sb, reps, params["groups"][gi], x, gc,
                                decode_pos=decode_pos)
        return norm_apply(cfg, params["final_norm"], x)

    # ---- entry points ------------------------------------------------------------------

    def train_loss(self, params: PyTree,
                   batch: dict) -> tuple[torch.Tensor, dict]:
        """The training forward (no cache) and the chunked cross entropy of
        ``batch["labels"]`` (optionally under ``batch["loss_mask"]``);
        returns ``(loss, {"xent", "moe_aux"})``. ``moe_aux`` is 0: the port
        trains dense models only. Training runs global attention only: the
        sLSTM scan (B8) has no autograd form yet, and the other mixers are
        not ported (ROADMAP.md)."""
        for sb, _ in self.cfg.groups:
            for spec in sb:
                if spec.mixer is not Mixer.GLOBAL_ATTN:
                    raise NotImplementedError(
                        f"{self.cfg.name}: training through "
                        f"{spec.mixer.value} is not yet ported")
        hidden = self.forward(params, batch["tokens"])
        loss = chunked_softmax_xent(self.cfg, params["embed"], hidden,
                                    batch["labels"], batch.get("loss_mask"))
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"xent": loss, "moe_aux": aux}

    @torch.no_grad()
    def prefill(self, params: PyTree, cache: PyTree,
                batch: dict) -> tuple[torch.Tensor, PyTree]:
        """Fill the caches from a full prompt; returns the last position's
        logits (B, 1, padded vocab) and the cache."""
        hidden = self.forward(params, batch["tokens"], cache=cache)
        return unembed_apply(self.cfg, params["embed"], hidden[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, params: PyTree, cache: PyTree, batch: dict,
                    pos: int) -> tuple[torch.Tensor, PyTree]:
        """One-token decode: ``batch["tokens"]`` is (B, 1); ``pos`` the
        absolute position being written."""
        hidden = self.forward(params, batch["tokens"], cache=cache,
                              decode_pos=int(pos))
        return unembed_apply(self.cfg, params["embed"], hidden), cache


def _row(tree: PyTree, rep: int) -> PyTree:
    """Row ``rep`` of every stacked leaf of a (nested) dict."""
    return {k: _row(v, rep) if isinstance(v, dict) else v[rep]
            for k, v in tree.items()}
