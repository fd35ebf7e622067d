"""Elastic supervision of the port: batch-size math and the restart agent."""
from .elastic_agent import DSElasticAgent  # noqa: F401
from .elasticity import (ElasticityConfigError, ElasticityError,  # noqa: F401
                         compute_elastic_config)
