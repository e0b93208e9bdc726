"""The benchmark entries: how a cell's configuration calls the port."""
