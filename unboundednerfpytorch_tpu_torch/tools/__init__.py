"""Command-line tools of the port: the COLMAP converter and the render server."""
