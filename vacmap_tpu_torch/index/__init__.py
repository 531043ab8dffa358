from .index import ReferenceIndex, merge_colinear_anchors
from .minimizer import minimizers, sketch_string, window_min_positions
