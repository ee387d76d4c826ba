from beach_seg_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    pad_to_multiple,
    param_sharding,
    put_batch,
    replicated,
    shard_batch,
    shard_model,
)
