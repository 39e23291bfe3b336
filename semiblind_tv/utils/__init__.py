from semiblind_tv.utils.images import load_image, synthetic_wheel, available_images  # noqa: F401
from semiblind_tv.utils.signals import (  # noqa: F401
    calctv,
    ensure,
    make_rd_squares,
    monotonize,
    sparse_pws,
    vectorized_operator,
)
