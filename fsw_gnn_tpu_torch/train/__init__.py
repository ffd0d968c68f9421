from .trainer import (TrainConfig, Trainer, lr_schedule,
                      masked_softmax_cross_entropy)
