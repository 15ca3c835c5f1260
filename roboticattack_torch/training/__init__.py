"""VLA fine-tuning and its infrastructure (the JAX package's `training/`)."""

from .checkpointing import latest_checkpoint, restore_checkpoint, save_checkpoint
from .metrics import VLAMetrics
from .overwatch import Overwatch, initialize_overwatch
from .strategies import TrainConfig, VLATrainer, fsdp_shardings, trainable_mask
from .preprocessing import ConversationDataset, SplitModalitySampler
