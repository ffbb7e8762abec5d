"""Training of the port (rsvldm_tpu/training): the LoRA / QLoRA finetune of
the caption decoder and its llama-3 data pipeline. Not ported yet (ROADMAP
item 15): the SR3 trainer, losses, EMA, lr schedules, MMTrainer and DPO."""

from .vlm_data import (LazyConversationDataset, get_length_grouped_indices,
                       get_modality_length_grouped_indices, preprocess)
from .vlm_trainer import (LoraConfig, VLMTrainer, apply_lora, export_merged,
                          init_lora, vlm_loss)
