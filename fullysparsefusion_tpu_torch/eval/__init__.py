"""Detection evaluation: the nuScenes-protocol metrics and the records of a model's detections."""
