#!/usr/bin/env python3
"""Standalone embedding CLI: re-embed features with trained weights
(the counterpart of ``abnet3_tpu/tools/embed_cli.py``, reference
tools/embed_cli.py:25-193).

    python -m abnet3_torch.tools.embed_cli experiment.yml -w weights.pth \
        -i input.h5f -o out.h5f

The YAML is a gridsearch experiment file; its model and embedder blocks
define the network the weights load into and the embedder's options
(``transfer_dtype``, ``streaming``, ``batch_size``). Like every entry
point of the port it runs on the card unless the model block says
``device: cpu`` and the embedder block ``cuda: false``. Without ``-i`` it
embeds the experiment's own features, generating them first when the
file is missing; without ``-o`` it writes the embedder block's
``output_path``, else ``<pathname_experience>/embeddings.h5f``.
"""

from __future__ import annotations

import argparse
import faulthandler
import os

import abnet3_torch.embedder
import abnet3_torch.features
import abnet3_torch.model
from abnet3_torch.gridsearch import _stage_class

__all__ = ["EmbedCLI", "main"]


class EmbedCLI:
    def __init__(self, yaml_file=None, weights=None, input_features=None,
                 output_embeddings=None):
        self.yaml_file = yaml_file
        self.weights = weights
        self.input_features = input_features
        self.output_embeddings = output_embeddings

    def parse_yaml_input_file(self):
        import yaml
        with open(self.yaml_file, "r") as stream:
            self.params = yaml.safe_load(stream)

    def run_embedding(self, single_experiment=None):
        if self.output_embeddings is None and \
                self.input_features is not None:
            raise ValueError("If you give a custom input, you have to "
                             "specify an output.")
        exp_path = single_experiment["pathname_experience"]

        model_prop = single_experiment["model"]
        model_class = _stage_class(abnet3_torch.model, model_prop["class"])
        arguments = dict(model_prop.get("arguments") or {})
        arguments["output_path"] = os.path.join(exp_path, "network")
        model = model_class(**arguments)

        if self.weights is not None:
            network_path = self.weights
        else:
            network_path = model.output_path + ".pth"

        if self.input_features is not None:
            feature_path = self.input_features
        else:
            # no -i: the experiment's own features, generated first when
            # the file does not exist yet (reference
            # tools/embed_cli.py:60-70)
            features_prop = single_experiment["features"]
            arguments = dict(features_prop.get("arguments") or {})
            arguments.setdefault("output_path",
                                 os.path.join(exp_path, "features"))
            feature_path = arguments["output_path"]
            if not os.path.exists(feature_path):
                features_class = _stage_class(abnet3_torch.features,
                                              features_prop["class"])
                features_class(**arguments).generate()
            print("Using default features : %s" % feature_path)

        embedder_prop = single_experiment["embedder"]
        embedder_class = _stage_class(abnet3_torch.embedder,
                                      embedder_prop["class"])
        arguments = dict(embedder_prop.get("arguments") or {})
        arguments["network"] = model
        arguments["network_path"] = network_path
        arguments["feature_path"] = feature_path
        if self.output_embeddings is not None:
            arguments["output_path"] = self.output_embeddings
        else:
            # the YAML's own output_path, as GridSearch honours it
            arguments.setdefault("output_path",
                                 os.path.join(exp_path, "embeddings.h5f"))
        embedder_class(**arguments).embed()

    def run(self):
        self.parse_yaml_input_file()
        self.run_embedding(self.params["default_params"])


def main(argv=None):
    faulthandler.enable()
    parser = argparse.ArgumentParser()
    parser.add_argument("exp_yml", type=str,
                        help="gridsearch yaml describing the experiment")
    parser.add_argument("-w", "--weights", type=str,
                        help="path to trained network weights (.pth)")
    parser.add_argument("-i", "--input-features", type=str,
                        help="input h5features file to embed")
    parser.add_argument("-o", "--output-embeddings", type=str,
                        help="output embeddings path")
    args = parser.parse_args(argv)
    cli = EmbedCLI(yaml_file=args.exp_yml, weights=args.weights,
                   input_features=args.input_features,
                   output_embeddings=args.output_embeddings)
    cli.run()


if __name__ == "__main__":
    main()
