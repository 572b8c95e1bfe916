from repro_torch.data.synthetic import (  # noqa: F401
    build_cold_store,
    synth_docs,
)
