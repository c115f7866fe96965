"""Host-side data: the NumPy point-cloud pipeline transforms and the Argoverse 2 reader."""
