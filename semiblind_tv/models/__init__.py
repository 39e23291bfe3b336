from semiblind_tv.models.psf_models import (  # noqa: F401
    ParamSpec,
    PsfModel,
    GaussianPsfModel,
    IsotropicGaussianPsfModel,
    LaplacePsfModel,
    MoffatPsfModel,
)
