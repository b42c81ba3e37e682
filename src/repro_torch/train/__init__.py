from .trainer import CheckpointWriter, Trainer, TrainerConfig
