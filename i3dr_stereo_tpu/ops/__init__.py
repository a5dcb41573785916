from i3dr_stereo_tpu.ops.rectify import RectifyMap, make_rectify_map, remap  # noqa: F401
from i3dr_stereo_tpu.ops.census import census_transform, census_cost_volume  # noqa: F401
from i3dr_stereo_tpu.ops.cost import (  # noqa: F401
    xsobel_prefilter,
    bt_cost_volume,
    sad_cost_volume,
    box_aggregate,
)
from i3dr_stereo_tpu.ops.sgm import sgm_aggregate, DIRECTIONS_8, DIRECTIONS_4  # noqa: F401
from i3dr_stereo_tpu.ops.wta import wta_disparity  # noqa: F401
from i3dr_stereo_tpu.ops.lr_check import lr_consistency, right_cost_volume  # noqa: F401
from i3dr_stereo_tpu.ops.speckle import speckle_filter  # noqa: F401
from i3dr_stereo_tpu.ops.median import median3x3  # noqa: F401
from i3dr_stereo_tpu.ops.depth import disparity_to_depth, disparity_to_pointcloud, crop_by_disparity  # noqa: F401
from i3dr_stereo_tpu.ops.occlusion import detect_occlusions, fill_occlusions  # noqa: F401
from i3dr_stereo_tpu.ops.subpix import halfpel_refine  # noqa: F401
from i3dr_stereo_tpu.ops.wls import wls_fill, wls_filter  # noqa: F401
from i3dr_stereo_tpu.ops.sgm_dispatch import sgm_aggregate_auto  # noqa: F401
