"""Inference engine v1: a model placed for serving and a generate loop over
a static KV cache.

Port of ``deepspeedsyclsupport_tpu/inference/engine.py``
(``init_inference`` / ``InferenceEngine``, the reference's
``deepspeed.init_inference``). The weights are placed by the same function
as the v2 engine's (``inference/params.py``): cast to the serving dtype
and, across ranks, cut to this rank's shards of the model's
``sharding_rules`` (the reference's auto-TP). :meth:`InferenceEngine.
generate` prefills the right-padded prompts in one ``decode_step`` and then
decodes one token a step over the model's static cache
(``CausalLM.decode_step``, written in place), with the JAX package's slot
masks: a row's prompt slots below its length and the shared decode slots
written so far are visible, at their logical positions, so padding never
shifts a position. Attention runs through the flash forward kernel on the
card (``layers.cached_flash_attention``: query positions and key segment
ids) and its plain version on the CPU. The loop is eager: each step is one
forward and one sample dispatched from the host (``host_dispatches``),
where the JAX package compiles the loop into one program.

Across ranks (a ``topology`` under a started process group, or the world
``init_inference`` builds from ``tensor_parallel.tp_size`` over the
group's ranks, leftover ranks serving as ``data``): every rank makes the
same calls, runs the layers on its heads and columns with
``reduce_from_model_region`` after ``o`` and ``down``, and samples from
the same all-gathered logits with a generator seeded alike.
"""
import copy
from typing import Any, Dict, Optional

import torch

from ..device import resolve_device
from .config import DSTpuInferenceConfig
from .params import place_inference_params, serving_mesh
from .sampling import SamplingParams, sample_token


def init_inference(model: Any = None, params: Any = None,
                   config: Optional[Dict] = None, device=None,
                   topology=None, **kwargs) -> "InferenceEngine":
    """Reference ``deepspeed.init_inference``. ``model``: a
    ``models.CausalLM``; ``params``: its params tree (default: the model's
    ``init_params`` on the device); ``kwargs`` merge into ``config``.
    ``device`` (default: the card) and ``topology`` are the port's
    arguments. A string ``model`` (an HF checkpoint directory) is not
    ported yet."""
    cfg = DSTpuInferenceConfig.from_config(config, **kwargs)
    if isinstance(model, str):
        raise NotImplementedError(
            "init_inference over an HF checkpoint directory is not ported "
            "yet: ROADMAP.md, queue A.3.5.4 (checkpoint/hf.py); build the "
            "model and pass its params")
    if model is None:
        raise ValueError("init_inference needs a model")
    if params is None:
        if not hasattr(model, "init_params"):
            raise ValueError("provide params, or a model with init_params()")
        params = model.init_params(device=device)
    return InferenceEngine(model, params, cfg, device=device,
                           topology=topology)


class InferenceEngine:
    def __init__(self, model: Any, params: Any, config: DSTpuInferenceConfig,
                 device=None, topology=None):
        from ..comm.topology import build_topology
        import torch.distributed as dist

        self.config = config
        self.device = resolve_device(device)
        tp = config.tensor_parallel.tp_size \
            if config.tensor_parallel.enabled else 1
        if topology is None and dist.is_available() and \
                dist.is_initialized():
            # the serving mesh: TP innermost, leftover ranks serve as data
            topology = build_topology(dp=-1, tp=tp)
        mesh_tp = 1 if topology is None else topology.axis_sizes["model"]
        if config.quant.enabled and max(tp, mesh_tp) > 1:
            # the JAX engine's refusal: ZeRO-Inference serves big models on
            # few cards
            raise ValueError("weight quantization (ZeRO-Inference) does not "
                             "compose with tensor_parallel yet")
        topology, _, specs = serving_mesh(model, topology)
        if topology is None and tp > 1:
            raise RuntimeError(
                f"tensor_parallel.tp_size {tp} needs {tp} ranks: call "
                f"comm.init_distributed first (one process a rank)")
        self.topology = topology
        self.module = model
        if topology is not None:
            from ..models.transformer import ParallelPlan

            # a private view: the caller's model keeps running on one card
            self.module = copy.copy(model)
            self.module.parallel = ParallelPlan(
                tp=topology.axis_sizes["model"], batch_axes=(), ep=1)
        self.tp = 1 if topology is None else topology.axis_sizes["model"]
        self.params = place_inference_params(params, config.dtype,
                                             self.device, topology, specs)
        if config.quant.enabled:
            self._quantize_weights(config.quant)
        self._generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        self.host_dispatches = 0

    def _quantize_weights(self, qcfg) -> None:
        """ZeRO-Inference: the layer weights as int8 / int4 codes and
        blockwise scales (``compression/quantize.py``), quantized after
        placement so the scales stay float32; each layer is dequantized
        when it runs (``CausalLM._block``)."""
        from ..compression.quantize import quantize_tree

        if not (isinstance(self.params, dict) and "layers" in self.params):
            raise ValueError(
                "weight quantization needs the framework model layout "
                "(params['layers'] consumed by models.CausalLM, which "
                "dequantizes a layer at a time)")
        self.params = dict(self.params)
        self.params["layers"] = quantize_tree(
            self.params["layers"], qcfg.group_size, qcfg.min_size,
            bits=qcfg.bits)

    def _full_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole vocabulary of the rank's ``V / tp`` logit columns."""
        if self.tp == 1:
            return logits
        from ..comm import comm

        return comm.all_gather(logits.contiguous(), "model", axis=-1)

    # ------------------------------------------------------------------ forward
    @torch.no_grad()
    def forward(self, input_ids, *args) -> torch.Tensor:
        """Full-sequence float32 logits ``[B, S, V]`` (reference
        ``InferenceEngine.forward``)."""
        ids = torch.as_tensor(input_ids, device=self.device)
        self.host_dispatches += 1
        return self._full_vocab(self.module.apply(self.params, ids, *args))

    __call__ = forward

    # ----------------------------------------------------------------- generate
    @torch.no_grad()
    def generate(self, input_ids, prompt_lens=None, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """Autoregressive generation: ``input_ids`` [B, S] right-padded
        prompts, ``prompt_lens`` [B] their lengths (default S). Returns
        ``[B, max_new_tokens]`` int32 ids on the device, the positions
        after an EOS filled with ``pad_token_id``. ``generator`` (default:
        the engine's, seeded from ``config.seed``) draws the samples."""
        cfg = self.config
        ids = torch.as_tensor(input_ids, device=self.device).long()
        b, s = ids.shape
        lens = (torch.full((b,), s, dtype=torch.long, device=self.device)
                if prompt_lens is None else
                torch.as_tensor(prompt_lens, device=self.device).long())
        eos = eos_token_id if eos_token_id is not None else cfg.eos_token_id
        eos = -1 if eos is None else int(eos)
        new = min(int(max_new_tokens), cfg.max_out_tokens)
        if s + new > cfg.max_seq_len:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({new}) exceeds "
                f"max_seq_len ({cfg.max_seq_len}); raise max_seq_len "
                f"in the inference config")
        sp = SamplingParams(do_sample, float(temperature), int(top_k),
                            float(top_p))
        gen = generator if generator is not None else self._generator
        model = self.module
        mcfg = model.config
        cache = model.init_kv_cache(
            b, s + new, dtype=cfg.dtype, device=self.device,
            host=cfg.kv_offload, kv_heads=mcfg.num_kv_heads // self.tp)
        positions = torch.arange(s, device=self.device)[None].expand(b, s)
        logits, cache = model.decode_step(self.params, cache, ids,
                                          positions=positions,
                                          rows=lens - 1)
        tok = sample_token(self._full_vocab(logits[:, 0]), gen, sp)
        self.host_dispatches += 2
        done = tok == eos if eos >= 0 else torch.zeros_like(tok,
                                                           dtype=torch.bool)
        out = [tok]
        slots = torch.arange(s + new, device=self.device)
        prompt_slot = slots[None] < lens[:, None]
        # a slot's logical position: the prompt's slots sit at their index,
        # decode slot s + j holds position len + j
        kv_pos = torch.where(slots[None] < s, slots[None],
                             lens[:, None] + (slots[None] - s))
        for t in range(new - 1):
            kv_mask = prompt_slot | ((slots >= s) & (slots <= s + t))[None]
            logits, cache = model.decode_step(
                self.params, cache, tok[:, None].long(),
                positions=(lens + t)[:, None], kv_mask=kv_mask,
                kv_positions=kv_pos)
            nxt = sample_token(self._full_vocab(logits[:, 0]), gen, sp)
            self.host_dispatches += 2
            if eos >= 0:
                nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id),
                                  nxt)
                done = done | (nxt == eos)
            tok = nxt
            out.append(tok)
        return torch.stack(out, dim=1)
