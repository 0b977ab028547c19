from .bitmap import (  # noqa: F401
    differentiate,
    intensity,
    load_exr,
    load_image,
    save_exr,
    save_image,
)
from .bmp import BmpImage, load_bmp, load_bmp_file, save_bmp, save_bmp_file  # noqa: F401
from .buffer import Buffer  # noqa: F401
from .image import Image, image_from_2d  # noqa: F401
