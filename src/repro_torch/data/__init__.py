# Synthetic deterministic data pipelines (host-sharded, prefetch), numpy only.
