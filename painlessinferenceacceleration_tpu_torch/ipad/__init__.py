"""IPAD: iterative pruning and distillation, the training side.

Port of ``painlessinferenceacceleration_tpu/ipad/``: a differentiable
full-sequence forward under channel masks (``train_forward.py``), AdamW in
optax's order (``optim.py``) and the prune-and-distill trainer
(``distill.py``): masks multiplied into the weights inside the loss,
unit saliency from |grad| * |weight|, schedules that shrink the masks step
by step, trainable-set finetunes, and ``reparam``, which slices the weights
to the pruned shape so the smaller model serves through ``engine/llm.py``.
"""

from painlessinferenceacceleration_tpu_torch.ipad.distill import (  # noqa: F401
    DistillConfig,
    Distiller,
    DistillPipe,
    DistillStage,
)
