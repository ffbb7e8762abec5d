"""Training of the port (rsvldm_tpu/training): the caption model's LoRA /
QLoRA, projector and DPO finetunes with their data pipeline, the SR3
trainer, the EMA, the lr schedules and the SDXL diffusion loss."""

from .ema import EmaState, ema_init, ema_update
from .losses import (StandardDiffusionLossConfig, discrete_sigma_sampling,
                     edm_sigma_sampling, standard_diffusion_loss)
from .lr_schedule import lambda_warmup_cosine, lambda_warmup_cosine2
from .sr3_trainer import SR3TrainConfig, SR3Trainer
from .vlm_data import (LazyConversationDataset, LazyPreferenceDataset,
                       collate, get_length_grouped_indices,
                       get_modality_length_grouped_indices, iter_batches,
                       preprocess)
from .vlm_trainer import (DPOTrainer, LoraConfig, MMTrainer, VLMTrainer,
                          apply_lora, dpo_loss, export_merged, init_lora,
                          mm_loss, vlm_loss)
