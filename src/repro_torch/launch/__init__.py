"""Launch: the shape cells, the production meshes, cell building and the dry run."""
