"""The port's models, chosen by a configuration's ``architecture`` key:
``unet`` (models/unet.py, the default where the key is absent) or
``segformer`` (models/segformer.py), either optionally tagged as
``<family>_<tag>`` (``unet_copy`` builds the U-Net)."""

ARCHITECTURES = ("unet", "segformer")


def architecture(config: dict) -> str:
    """The model family a merged config dict names."""
    name = str(config.get("architecture") or "unet")
    family = name.partition("_")[0]
    if family not in ARCHITECTURES:
        raise ValueError(f"architecture must be one of {ARCHITECTURES}, "
                         f"or one of them followed by _<tag>, got {name!r}")
    return family


def build_model(config: dict):
    """The model of a merged config dict, as every entry point builds
    it."""
    if architecture(config) == "segformer":
        from .segformer import build_segformer
        return build_segformer(config)
    from .unet import build_unet
    return build_unet(config)


def init_train_(model, generator):
    """The model's training initialisation drawn from ``generator``."""
    from .segformer import SegFormer
    if isinstance(model, SegFormer):
        from .segformer import init_train_ as init
    else:
        from .unet import init_train_ as init
    return init(model, generator)
