"""Query execution: fused scan→decode→filter→aggregate on the device.

The reference's read path is iterator-shaped (src/read/deserialize.rs); this
engine is batch-shaped: a host *planner* parses page structure once and
uploads dense page bodies to device memory; jit-compiled decode kernels rebuild column
values on device; filters and aggregates fuse behind the same jit boundary.
"""

from .scan import DeviceColumn, DeviceTable, scan_file  # noqa: F401
from .dataset import (  # noqa: F401
    concat_device_tables,
    iter_dataset_chunks,
    scan_dataset,
)
from .resident import ResidentTable, load_resident, make_resident  # noqa: F401
from .query import Query  # noqa: F401
from .expr import col, lit  # noqa: F401
from .aggregate import hash_aggregate, dense_group_sum  # noqa: F401
from .join import hash_join  # noqa: F401
