"""Device-mesh parallelism on ``torch.distributed`` (PyTorch port).

Counterpart of ``rho_tts_tpu/parallel``: one process per GPU, every rank
making the same call and getting the whole result (``mesh``), plain local
shards and explicit collectives (``collectives``) where XLA inserts its
own. Data, tensor and sequence parallelism for inference and serving
(``inference``); data and tensor parallelism for training through the
differentiable collectives (``models.qwen.train`` / ``lora`` with
``mesh=``), and GPipe pipeline parallelism (``pipeline``).
"""

from .inference import (
    enable_data_parallel,
    enable_parallelism,
    enable_sequence_parallel,
    enable_tensor_parallel,
)
from .mesh import create_mesh, default_mesh_shape
from .pipeline import (
    create_pipeline_mesh,
    pipeline_stack_forward,
    pipeline_train_step,
    shard_stack_for_pipeline,
    stage_specs,
)
from .sharding import (
    batch_sharding,
    chatterbox_param_specs,
    gather_params,
    param_shardings,
    param_specs_for,
    qwen_param_specs,
    shard_params,
)
