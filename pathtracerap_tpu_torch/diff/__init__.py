from .grad import (
    apply_params,
    extract_params,
    geometry_loss,
    image_loss,
    loss_and_grad,
    make_sharded_train_step,
    make_train_step,
    render_aovs,
    render_for_params,
)

__all__ = [
    "extract_params",
    "apply_params",
    "render_for_params",
    "render_aovs",
    "image_loss",
    "geometry_loss",
    "loss_and_grad",
    "make_train_step",
    "make_sharded_train_step",
]
