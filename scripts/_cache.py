"""Enable the persistent compile cache for all profiling scripts."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from blockbasedmotionestimation.utils import compile_cache

compile_cache.enable()
