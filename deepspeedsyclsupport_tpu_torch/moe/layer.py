"""Import-path compat: ``deepspeed.moe.layer.MoE`` (reference
``deepspeed/moe/layer.py:16``).

Port of ``deepspeedsyclsupport_tpu/moe/layer.py``. MoE is a CONFIG
property of the causal LM here, as in the JAX package
(``ModelConfig.num_experts`` -> ``parallel/moe.moe_mlp`` in each layer):
this shim carries the reference constructor surface and resolves it onto
that config (:meth:`MoE.model_config_kwargs`), warning, as the JAX package
does, about the knobs that have no mapping instead of eating them. The
expert-parallel size (``ep_size``) is the mesh's ``expert`` axis, set by
the engine's ``parallelism.ep`` / ``moe.expert_parallel_size``.
"""
from typing import Any, Optional

from ..parallel.moe import moe_mlp, topk_gating  # noqa: F401


class MoE:
    """Reference ``deepspeed.moe.layer.MoE`` constructor surface. Use the
    captured fields to build a ``ModelConfig`` (``num_experts``,
    ``num_experts_per_tok=k``, ``capacity_factor``); the model's MoE
    layers replace the module-tree wrapping."""

    def __init__(self, hidden_size: int, expert: Any = None,
                 num_experts: int = 1, ep_size: int = 1, k: int = 1,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4, use_residual: bool = False,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, use_rts: bool = True,
                 use_tutel: bool = False,
                 enable_expert_tensor_parallelism: bool = False,
                 top2_2nd_expert_sampling: bool = True):
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.ep_size = ep_size
        self.k = k
        self.capacity_factor = capacity_factor
        self.use_residual = use_residual
        from ..utils.logging import logger

        # knobs with no ModelConfig mapping are not eaten silently: a
        # Residual-MoE or noisy-gate model would build another architecture
        if use_residual:
            logger.warning("MoE(use_residual=True) has no equivalent "
                           "here yet; building a standard top-k MoE")
        if noisy_gate_policy not in (None, "None"):
            logger.warning("MoE noisy_gate_policy=%r ignored (router_jitter"
                           " in ModelConfig is the supported noise knob)",
                           noisy_gate_policy)
        if not drop_tokens:
            logger.warning("MoE(drop_tokens=False): training uses the "
                           "capacity path; the no-drop grouped-GEMM path "
                           "serves inference (parallel/moe.moe_mlp_nodrop)")

    def model_config_kwargs(self) -> dict:
        """The ``ModelConfig`` fields this MoE spec maps to."""
        return {"num_experts": self.num_experts,
                "num_experts_per_tok": self.k,
                "capacity_factor": self.capacity_factor}
