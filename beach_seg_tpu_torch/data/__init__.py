from beach_seg_tpu_torch.data.dataset import (
    BeachSegDataset,
    Scene,
    create_scene,
    get_crop_arrays,
    iterate_batches,
    materialize_prompts,
)
from beach_seg_tpu_torch.data.prefetch import MosaicPrefetcher, prefetch_iterator
