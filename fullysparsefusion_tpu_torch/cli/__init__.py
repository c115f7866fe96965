"""Command-line entry points of the port: the fake nuScenes tree writer, the
GT-database tool, training and evaluation."""
