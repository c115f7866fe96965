"""Host-side data: the NumPy point-cloud pipeline transforms, the nuScenes and
Argoverse 2 readers, CBGS, GT paste, TTA, the offline masks and their PNG
codec, and the host loader library."""
