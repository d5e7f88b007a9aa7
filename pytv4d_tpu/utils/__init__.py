from . import checks, compile_cache, images, metrics, profiling, runlog
from .checks import assert_finite, checkified
from .compile_cache import enable_compile_cache, warm_compile
from .images import (
    as_volume,
    blob_phantom,
    cameraman,
    has_real_cameraman,
    synthetic_phantom,
)
from .metrics import mse, nrmse, psnr, ssim
from .profiling import (
    IterationTimer,
    cp_traffic_model,
    device_peaks,
    roofline_fraction,
    tgv_traffic_model,
    trace,
)
from .runlog import log_run
