"""Launch layer: the multi-tenant server (serve_tm)."""
