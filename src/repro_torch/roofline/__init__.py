from . import hw, analysis
