"""Launchers of the port: the serve engine and its paged KV table, the
train entry point, the meshes, the roofline terms, the dry run and its
sweep."""
