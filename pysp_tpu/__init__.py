"""pysp_tpu — an accelerator-native raw photo development framework in JAX.

Full capability surface of bullbin/pySP (see SURVEY.md), rebuilt for the accelerator:
host-side decode/metadata/WB-solve feeding immutable pytrees, with every per-pixel
stage compiled into fused XLA programs (vmappable over bursts, shardable over a
('batch', 'spatial') device mesh).

Canonical flow (the reference's README pipeline, one jitted program):

    from pysp_tpu import load_raw, develop, DevelopConfig, QualityDemosaic
    frame = load_raw("shot.dng")
    srgb = develop(frame, DevelopConfig(quality=QualityDemosaic.Best))
"""

from .const import BayerPattern, PatternDemosaic, QualityDemosaic
from .core.bayer import (
    bayer_to_planes,
    bayer_to_rgbg,
    planes_to_bayer,
    reversible_transform_rggb,
    rgbg_to_bayer,
)
from .core.frame import DevelopedImage, RawFrame
from .core.normalization import bayer_normalize
from .colorimetry.transforms import (
    cam_to_clean_xyz,
    cam_to_lin_srgb,
    lin_srgb_to_oklab,
    lin_srgb_to_srgb,
    oklab_to_lin_srgb,
    srgb_to_lin_srgb,
)
from .colorimetry.wb import CameraWhiteBalanceController, controller_from_tags
from .demosaic import demosaic, demosaic_ahd, demosaic_draft, demosaic_eag
from .pipeline.develop import DevelopConfig, develop, develop_burst, develop_to_image
from .pipeline.pipeline import PipelineConfig, develop_pipeline
from .pipeline.stream import develop_files, develop_stream
from .io.raw_loader import frame_from_parts, load_raw, load_raw_dng
from .io.arw import load_raw_arw
from .io.cr2 import load_raw_cr2
from .io.nef import load_raw_nef
from .io.orf import load_raw_orf
from .io.cr3 import cr3_info
from .io.mrw import load_raw_mrw
from .io.pef import load_raw_pef
from .io.srw import load_raw_srw
from .io.raf import load_raw_raf
from .io.rw2 import load_raw_rw2
from .io.camera_matrices import register_camera_matrices
from .io.metadata import (
    compute_ev,
    compute_ev_from_tiff,
    get_image_area_from_tiff,
    get_opcode_3_block,
    get_opcode_block,
)
from .correct.bad_pixels import (
    find_erroneous_pixels_median,
    find_erroneous_pixels_threshold,
    find_shared_pixels,
    repair_bad_pixels,
)
from .correct.flat_field import (
    bias_frame_subtraction,
    dark_frame_subtraction,
    flat_frame_correction,
)
from .correct.denoise import denoise_bayer_wavelet
from .correct.hdr import fuse_exposures_from_debayer, fuse_exposures_to_raw
from .correct.ca.models import (
    Poly3CorrectionModel,
    Poly5CorrectionModel,
    PtLensCorrectionModel,
)
from .correct.ca.instability import compute_structural_instability
from .correct.ca.models import lensfun_poly3_remap_coords
from .correct.ca.removal import compute_ca_lens_models_for_raw, remove_ca_from_raw
from .correct.ca.gradfit import (
    fit_ca_models_gradient,
    fit_poly3_gradient,
    fit_radial_gradient,
    refine_ca_models_gradient,
)
from .io.raw_loader import load_burst
from .ops.resample import bilinear_sample, remap_bilinear, remap_lanczos4
from .parallel.mesh import make_mesh
from .parallel.spatial import (
    develop_burst_sharded,
    develop_burst_spatial,
    develop_spatial,
)
from .pipeline.develop import develop_with_stats
from .warp.opcodes import apply_opcode_3_warp, encode_warp_rectilinear, stack_warp_prior
from .warp.gain_opcodes import (
    GainMap,
    VignetteRadial,
    apply_gain_opcodes,
    encode_gain_map,
    encode_opcode_list,
    encode_vignette_radial,
)
from .warp.rectilinear import (
    compute_offset_remapping_table,
    compute_remapping_table,
    warp_channel_rectilinear,
)
from .filters.blur import blur_gaussian
from .filters.sharpen import (
    gaussian_rt_deconvolution,
    gaussian_rt_deconvolution_lab,
    gaussian_rt_deconvolution_yuv,
    unsharp_mask_lab,
    unsharp_mask_per_channel,
)

__version__ = "0.1.0"

__all__ = [
    "BayerPattern",
    "PatternDemosaic",
    "QualityDemosaic",
    "RawFrame",
    "DevelopedImage",
    "DevelopConfig",
    "PipelineConfig",
    "develop",
    "develop_pipeline",
    "develop_files",
    "develop_stream",
    "develop_burst",
    "develop_to_image",
    "demosaic",
    "demosaic_ahd",
    "demosaic_draft",
    "demosaic_eag",
    "load_raw",
    "load_raw_arw",
    "load_raw_cr2",
    "load_raw_dng",
    "load_raw_nef",
    "load_raw_orf",
    "cr3_info",
    "load_raw_mrw",
    "load_raw_pef",
    "load_raw_srw",
    "load_raw_raf",
    "load_raw_rw2",
    "register_camera_matrices",
    "frame_from_parts",
    "bayer_normalize",
    "bayer_to_rgbg",
    "rgbg_to_bayer",
    "bayer_to_planes",
    "planes_to_bayer",
    "reversible_transform_rggb",
    "cam_to_lin_srgb",
    "cam_to_clean_xyz",
    "lin_srgb_to_srgb",
    "srgb_to_lin_srgb",
    "lin_srgb_to_oklab",
    "oklab_to_lin_srgb",
    "CameraWhiteBalanceController",
    "controller_from_tags",
    "compute_ev",
    "compute_ev_from_tiff",
    "get_image_area_from_tiff",
    "get_opcode_3_block",
    "get_opcode_block",
    "find_erroneous_pixels_threshold",
    "find_erroneous_pixels_median",
    "find_shared_pixels",
    "repair_bad_pixels",
    "flat_frame_correction",
    "dark_frame_subtraction",
    "bias_frame_subtraction",
    "denoise_bayer_wavelet",
    "fuse_exposures_to_raw",
    "fuse_exposures_from_debayer",
    "Poly3CorrectionModel",
    "Poly5CorrectionModel",
    "PtLensCorrectionModel",
    "compute_ca_lens_models_for_raw",
    "remove_ca_from_raw",
    "apply_opcode_3_warp",
    "apply_gain_opcodes",
    "GainMap",
    "VignetteRadial",
    "encode_gain_map",
    "encode_vignette_radial",
    "encode_opcode_list",
    "encode_warp_rectilinear",
    "stack_warp_prior",
    "compute_remapping_table",
    "compute_offset_remapping_table",
    "warp_channel_rectilinear",
    "compute_structural_instability",
    "lensfun_poly3_remap_coords",
    "load_burst",
    "remap_bilinear",
    "remap_lanczos4",
    "bilinear_sample",
    "make_mesh",
    "develop_spatial",
    "develop_burst_sharded",
    "develop_burst_spatial",
    "develop_with_stats",
    "blur_gaussian",
    "unsharp_mask_per_channel",
    "unsharp_mask_lab",
    "gaussian_rt_deconvolution",
    "gaussian_rt_deconvolution_lab",
    "gaussian_rt_deconvolution_yuv",
]
