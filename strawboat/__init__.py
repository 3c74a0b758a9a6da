"""strawboat: a columnar storage format + vectorized query engine on the GPU.

Built from scratch in JAX/XLA (+ native host codecs) with the
capabilities of the Rust ``strawboat`` storage format (see SURVEY.md):
an Arrow-schema'd page-based file format with adaptive per-page compression,
streaming/batch readers with page skipping, page introspection (stat), and —
beyond the reference — a fused on-device scan→decode→filter pipeline, hash
aggregate / join operators, and multi-host scale-out over a JAX device mesh.
"""

__version__ = "0.1.0"

from .constants import Compression, ARROW_MAGIC, CONTINUATION_MARKER  # noqa: F401
from .meta import ColumnMeta, PageMeta  # noqa: F401
from .errors import StrawboatError, OutOfSpecError  # noqa: F401
