from .synthetic import (  # noqa: F401
    DATASET_PRESETS,
    DatasetSpec,
    make_dataset,
    make_queries,
)
