"""The harness: cells, corpus, pairs, drivers, tracing and the check."""
