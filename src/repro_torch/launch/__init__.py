"""Launchers of the port: the serve engine and its paged KV table."""
