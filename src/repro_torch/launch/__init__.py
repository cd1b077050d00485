"""Launch helpers: the production mesh shapes and process-group meshes,
the analytic roofline, the shape cells and their dry run on the meta
device."""
