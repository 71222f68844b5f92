"""The Parquet read path (the JAX package's parquet/).

Footer side, the reference's ParquetFooter.java surface: a schema
description DSL (``SchemaBuilder``), ``read_and_filter`` (prune a raw
footer to a read schema and a split's row groups), row/column counts and
``serialize_thrift_file``. Reader side: ``ParquetReader`` (chunked, with
predicate pushdown) and ``read_parquet``, decoding on the card's device
tier by default (parquet/device_decode.py) or on the native host tier.
"""

from .footer import (
    FooterSchema,
    ParquetFooter,
    SchemaBuilder,
    read_and_filter,
)
from .reader import ParquetReader, read_parquet

__all__ = ["FooterSchema", "ParquetFooter", "SchemaBuilder", "read_and_filter",
           "ParquetReader", "read_parquet"]
