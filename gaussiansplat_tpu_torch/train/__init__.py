from .loss import l1, photometric_loss, psnr, ssim, ssim_map
from .trainer import (
    TrainState,
    Trainer,
    evaluate,
    init_train_state,
    make_densify_fn,
    make_eval_fn,
    make_opacity_reset_fn,
    make_optimizer,
    make_train_step,
    position_lr_schedule,
    set_position_lr,
)

__all__ = [
    "TrainState",
    "Trainer",
    "evaluate",
    "init_train_state",
    "l1",
    "make_densify_fn",
    "make_eval_fn",
    "make_opacity_reset_fn",
    "make_optimizer",
    "make_train_step",
    "photometric_loss",
    "position_lr_schedule",
    "psnr",
    "set_position_lr",
    "ssim",
    "ssim_map",
]
