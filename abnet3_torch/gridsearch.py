#!/usr/bin/env python3
"""Gridsearch orchestrator + main CLI entry point.

The counterpart of ``abnet3_tpu/gridsearch.py``: it drives the full
pipeline (features -> sampler -> trainer -> embedder -> optional ABX) from
a YAML experiment file with the same schema (reference
gridsearch.py:30-335 and gridsearch.md): ``default_params`` with one
``{class, arguments}`` block per stage, an optional one-parameter-at-a-time
``grid_params`` sweep, per-stage ``run`` lifecycle modes, and
``test_files`` embedding of held-out corpora. Stage classes are resolved by
name from the port's modules; a class that the JAX package has and the
port does not yet raises ``NotImplementedError`` naming its ROADMAP item.

Each stage takes its device from its own YAML arguments (``device: cpu``
on the features, dataloader, model and abx blocks, ``cuda: false`` on the
trainer and the embedder); without them every stage runs on the card.
``num_jobs`` runs the grid's experiments in a spawn pool, worker k on card
k mod the number of cards. ``yaml`` is imported only where a YAML file is
read or written.

A mesh runs one process per GPU: ``torchrun --nproc_per_node N -m
abnet3_torch.gridsearch exp.yaml`` with ``mesh: {data: N}`` (and
``model: M``) among the trainer's and the embedder's arguments (and the
abx block's). Each rank takes card LOCAL_RANK; rank 0 alone writes the
shared files (features, pair files, ``exp.yml``, weights, embeddings,
``abx.json``) and the other ranks wait for it, then read them.
"""

from __future__ import annotations

import argparse
import copy
import datetime
import faulthandler
import os
import shutil
import time
from typing import Dict, List

import torch

from abnet3_torch.dist import barrier, from_writer, is_writer
import abnet3_torch.dataloader
import abnet3_torch.embedder
import abnet3_torch.features
import abnet3_torch.loss
import abnet3_torch.model
import abnet3_torch.sampler
import abnet3_torch.trainer

__all__ = ["GridSearch", "main"]

# classes of the JAX package's stage modules not ported yet, with the
# ROADMAP.md item that ports them (every stage class is ported)
_UNPORTED: Dict[str, str] = {}


def _stage_class(module, name):
    """The class ``name`` of a stage module, by reflection."""
    cls = getattr(module, name, None)
    if cls is not None:
        return cls
    if name in _UNPORTED:
        raise NotImplementedError(
            f"{name} is not ported to abnet3_torch yet (ROADMAP.md "
            f"{_UNPORTED[name]}); abnet3_tpu.gridsearch runs it")
    raise AttributeError(
        f"module {module.__name__!r} has no class {name!r}")


class GridSearch:
    """YAML-driven experiment runner (reference gridsearch.py:30-290)."""

    def __init__(self, input_file=None, num_jobs=1, gpu_ids=None, date=None,
                 embed_only=False, test_files=None, test_only=False):
        self.input_file = input_file
        self.num_jobs = num_jobs
        self.gpu_ids = gpu_ids
        self.sampler_run = False
        self.features_run = False
        self.date = date
        self.embed_only = embed_only
        self.test_files = test_files
        self.test_only = test_only

    def whoami(self):
        raise NotImplementedError("Unimplemented whoami for class:",
                                  self.__class__.__name__)

    def parse_yaml_input_file(self):
        import yaml
        with open(self.input_file, "r") as stream:
            self.params = yaml.safe_load(stream)

    def build_grid_experiments(self) -> List[Dict]:
        """Expand grid_params into experiment dicts
        (reference gridsearch.py:70-127)."""
        import yaml
        self.parse_yaml_input_file()
        msg = "Yaml not well formatted : "
        assert self.params["default_params"], msg + "default_params"
        assert self.params["default_params"]["pathname_experience"], \
            msg + "pathname_experience"
        default_params = self.params["default_params"]

        if self.test_files:
            test_files = []
            for path in self.test_files:
                with open(path, "r") as f:
                    test_files.append(yaml.safe_load(f))
            self.test_files = test_files
        else:
            self.test_files = []
        if "test_files" in self.params:
            for test_file in self.params["test_files"]:
                self.test_files.append(self.params["test_files"][test_file])

        if "grid_params" not in self.params:
            return [default_params]

        grid_params = self.params["grid_params"]
        grid_experiments = []
        now = datetime.datetime.now().isoformat()
        if self.date is not None:
            now = self.date
        # every rank of a mesh run names the experiments as rank 0 does
        now = from_writer(now)

        for submodule, submodule_params in grid_params.items():
            for param, values in (submodule_params.get("arguments")
                                  or {}).items():
                for value in values:
                    if isinstance(values, dict):
                        name = value
                        value = values[name]
                    else:
                        name = value
                    current_exp = copy.deepcopy(default_params)
                    current_exp.setdefault(submodule, {})
                    current_exp[submodule].setdefault("arguments", {})
                    current_exp[submodule]["arguments"][param] = value
                    current_exp["pathname_experience"] = os.path.join(
                        default_params["pathname_experience"], now, param,
                        str(name).replace("/", ".").lstrip("."))
                    grid_experiments.append(current_exp)
        return grid_experiments

    # -- single experiment ---------------------------------------------------

    def _instantiate(self, single_experiment):
        """Build the 7 stage objects by class-name reflection with
        auto-wired paths (reference gridsearch.py:145-202)."""
        exp_path = single_experiment["pathname_experience"]

        features_prop = single_experiment["features"]
        features_class = _stage_class(abnet3_torch.features,
                                      features_prop["class"])
        arguments = dict(features_prop["arguments"] or {})
        arguments.setdefault("output_path",
                             os.path.join(exp_path, "features"))
        features = features_class(**arguments)

        sampler_prop = single_experiment["sampler"]
        sampler_class = _stage_class(abnet3_torch.sampler,
                                     sampler_prop["class"])
        arguments = dict(sampler_prop["arguments"] or {})
        arguments.setdefault("directory_output",
                             os.path.join(exp_path, "pairs"))
        sampler = sampler_class(**arguments)

        model_prop = single_experiment["model"]
        model_class = _stage_class(abnet3_torch.model, model_prop["class"])
        arguments = dict(model_prop["arguments"] or {})
        arguments["output_path"] = os.path.join(exp_path, "network")
        model = model_class(**arguments)

        loss_prop = single_experiment["loss"]
        loss_class = _stage_class(abnet3_torch.loss, loss_prop["class"])
        loss_args = dict(loss_prop["arguments"] or {})
        # nested {class, arguments} dicts resolve recursively
        for k, v in list(loss_args.items()):
            if isinstance(v, dict) and "class" in v:
                sub_class = _stage_class(abnet3_torch.loss, v["class"])
                loss_args[k] = sub_class(**dict(v.get("arguments") or {}))
        loss = loss_class(**loss_args)

        dataloader_prop = single_experiment["dataloader"]
        dataloader_class = _stage_class(abnet3_torch.dataloader,
                                        dataloader_prop["class"])
        arguments = dict(dataloader_prop["arguments"] or {})
        arguments.setdefault("pairs_path", sampler.directory_output)
        arguments["features_path"] = features.output_path
        dataloader = dataloader_class(**arguments)

        trainer_prop = single_experiment["trainer"]
        trainer_class = _stage_class(abnet3_torch.trainer,
                                     trainer_prop["class"])
        arguments = dict(trainer_prop["arguments"] or {})
        arguments["network"] = model
        arguments["loss"] = loss
        arguments["dataloader"] = dataloader
        arguments["log_dir"] = os.path.join(exp_path, "logs")
        trainer = trainer_class(**arguments)

        embedder_prop = single_experiment["embedder"]
        embedder_class = _stage_class(abnet3_torch.embedder,
                                      embedder_prop["class"])
        arguments = dict(embedder_prop["arguments"] or {})
        arguments["network"] = model
        arguments.setdefault("output_path",
                             os.path.join(exp_path, "embeddings.h5f"))
        arguments["feature_path"] = features.output_path
        arguments["network_path"] = model.output_path + ".pth"
        embedder = embedder_class(**arguments)

        return features, sampler, model, loss, dataloader, trainer, embedder

    @staticmethod
    def _sample_fresh(sampler):
        """sampler.sample() refuses to overwrite its output directory
        (the reference's bare os.makedirs), but an experiment may be run
        again (main() warns about overwriting and proceeds on 'y'), so a
        stale pairs directory from the previous run is removed first."""
        if sampler.directory_output and \
                os.path.isdir(sampler.directory_output):
            print("Removing stale pairs directory %s"
                  % sampler.directory_output)
            shutil.rmtree(sampler.directory_output)
        sampler.sample()

    @staticmethod
    def _on_rank0(fn):
        """``fn()`` on the rank that writes shared files; the others wait
        for it (every process without a mesh runs it)."""
        if is_writer():
            fn()
        barrier()

    def _prerun_once_stages(self, single_experiment):
        """Execute run='once' features/sampler stages serially (before
        the parallel workers start, which would race on their outputs)."""
        os.makedirs(single_experiment["pathname_experience"], exist_ok=True)
        features, sampler = self._instantiate(single_experiment)[:2]
        if features.run == "once":
            self._on_rank0(features.generate)
            self.features_run = True
        if sampler.run == "once":
            self._on_rank0(lambda: self._sample_fresh(sampler))
            self.sampler_run = True

    def run_single_experiment(self, single_experiment=None, gpu_id=0):
        """One experiment: features -> sampler -> train -> embed -> ABX ->
        test embeddings (reference gridsearch.py:129-277)."""
        import yaml
        for stage in ("features", "sampler", "trainer", "embedder", "model",
                      "loss"):
            assert single_experiment[stage], f"{stage} properties missing"

        os.makedirs(single_experiment["pathname_experience"], exist_ok=True)
        if is_writer():
            with open(os.path.join(single_experiment["pathname_experience"],
                                   "exp.yml"), "w") as f:
                yaml.dump(single_experiment, f, default_flow_style=False)

        (features, sampler, model, loss, dataloader, trainer,
         embedder) = self._instantiate(single_experiment)

        if not self.test_only:
            if self.embed_only:
                embedder.embed()
                self._run_abx(single_experiment, sampler, embedder)
                return

            if features.run == "never":
                pass
            elif features.run == "once" and not self.features_run:
                self._on_rank0(features.generate)
                self.features_run = True
            elif features.run == "always":
                self._on_rank0(features.generate)
            elif features.run == "if_none":
                # rank 0 alone tests the file: another rank could see it
                # while rank 0 writes it
                self._on_rank0(lambda: os.path.isfile(
                    features.output_path) or features.generate())

            if sampler.run == "never":
                pass
            elif sampler.run == "once" and not self.sampler_run:
                self._on_rank0(lambda: self._sample_fresh(sampler))
                self.sampler_run = True
            elif sampler.run == "always":
                self._on_rank0(lambda: self._sample_fresh(sampler))

            trainer.train()
            embedder.embed()
            self._run_abx(single_experiment, sampler, embedder)

        if self.test_files:
            for file in self.test_files:
                self._embed_test_file(single_experiment, model, file)

    def _run_abx(self, single_experiment, sampler, embedder):
        """Optional ABX scoring of the exported embeddings (an ``abx`` YAML
        block with ``run`` + ``evaluate()`` arguments), written to
        ``abx.json`` in the experiment directory. The token inventory
        defaults to the sampler's .classes file, the speaker map to its
        spkid_file; the arguments go to
        :func:`abnet3_torch.eval.abx.evaluate` as they are
        (``score_backend``, ``checkpoint_path``, ``device_rows_per_block``
        and ``device`` among them). The multitask embedder's phone head
        (``.phn``), the subword stream, is the one scored; the multimodal
        embedder's ``embedded.features``."""
        abx_prop = single_experiment.get("abx")
        if not abx_prop or abx_prop.get("run", "always") == "never":
            return
        import json

        from abnet3_torch.eval.abx import evaluate

        args = dict(abx_prop.get("arguments") or {})
        classes = args.pop("classes_path", None) or getattr(
            sampler, "std_file", None)
        if not classes:
            raise ValueError("the abx block needs a classes_path "
                             "argument (or a sampler with std_file)")
        args.setdefault("spkid_file", getattr(sampler, "spkid_file",
                                              None))
        emb_path = abx_prop.get("features_path")
        if emb_path is None:
            emb_path = embedder.output_path
            if isinstance(embedder,
                          abnet3_torch.embedder.EmbedderSiameseMultitask):
                emb_path += ".phn"
            elif isinstance(embedder,
                            abnet3_torch.embedder.MultimodalEmbedder):
                emb_path += "embedded.features"
        result = evaluate(emb_path, classes, **args)
        out = os.path.join(single_experiment["pathname_experience"],
                           "abx.json")
        if is_writer():
            with open(out, "w") as f:
                f.write(json.dumps(result) + "\n")
        print("ABX (%s, %s): error=%.4f over %d triplets -> %s"
              % (result["task"], result["distance"], result["error"],
                 result["n_triplets"], out))

    def _embed_test_file(self, single_experiment, model, file):
        """Generate features for a held-out corpus and embed it
        (reference gridsearch.py:234-277)."""
        test_wavs = file["files"]
        name = file["name"]
        exp_path = single_experiment["pathname_experience"]
        test_features = file.get("features",
                                 os.path.join(exp_path, f"test-{name}"))
        vad_file = file.get("vad_file")

        if not os.path.exists(test_features):
            print("Creating test features for %s at path %s"
                  % (name, test_features))
            features_prop = single_experiment["features"]
            features_class = _stage_class(abnet3_torch.features,
                                          features_prop["class"])
            arguments = dict(features_prop["arguments"] or {})
            arguments["files"] = test_wavs
            arguments["vad_file"] = vad_file
            arguments["output_path"] = test_features
            self._on_rank0(features_class(**arguments).generate)

        embedder_prop = single_experiment["embedder"]
        embedder_class = _stage_class(abnet3_torch.embedder,
                                      embedder_prop["class"])
        arguments = dict(embedder_prop["arguments"] or {})
        arguments["network"] = model
        output_path = os.path.join(exp_path, name)
        arguments["output_path"] = output_path
        arguments["feature_path"] = test_features
        arguments["network_path"] = model.output_path + ".pth"
        embedder = embedder_class(**arguments)
        print("Embedding test features {} at path {}".format(name,
                                                             output_path))
        embedder.embed()

    def run(self):
        """Run all grid experiments, in parallel worker processes when
        ``num_jobs`` > 1 (the reference declared num_jobs and left it
        unimplemented, reference gridsearch.py:299-300). Under
        ``torchrun`` every rank runs every experiment as one rank of its
        mesh."""
        from abnet3_torch.parallel.mesh import init_from_env
        ranks = init_from_env()
        if ranks and self.num_jobs and self.num_jobs > 1:
            raise ValueError("num_jobs > 1 runs experiments in worker "
                             "processes; under torchrun use num_jobs 1")
        grid_experiments = self.build_grid_experiments()
        print("Start the grid search ...")
        if self.num_jobs and self.num_jobs > 1 and len(grid_experiments) > 1:
            # run-once stages (feature and pair files shared across the
            # grid) run before the pool: concurrent workers would race on
            # the same output paths
            if not (self.embed_only or self.test_only):
                self._prerun_once_stages(grid_experiments[0])
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
            with ctx.Pool(processes=min(self.num_jobs,
                                        len(grid_experiments))) as pool:
                pool.map(_run_experiment_worker,
                         [(k, self.input_file, exp, self.test_files,
                           self.embed_only, self.test_only,
                           self.features_run, self.sampler_run)
                          for k, exp in enumerate(grid_experiments)])
            return
        # under torchrun init_from_env took card LOCAL_RANK
        if (not ranks and self.gpu_ids is not None
                and torch.cuda.is_available()):
            torch.cuda.set_device(int(self.gpu_ids))
        for index, exp in enumerate(grid_experiments):
            print("Starting exp {} : {}".format(
                index, exp["pathname_experience"]))
            self.run_single_experiment(single_experiment=exp)


def _run_experiment_worker(args):
    """Module-level worker for the spawn pool: experiment k of the grid,
    on card k mod the number of cards when there is a card."""
    (k, input_file, exp, test_files, embed_only, test_only,
     features_run, sampler_run) = args
    if torch.cuda.is_available():
        torch.cuda.set_device(k % torch.cuda.device_count())
    grid = GridSearch(input_file=input_file, num_jobs=1,
                      embed_only=embed_only, test_only=test_only)
    grid.features_run = features_run
    grid.sampler_run = sampler_run
    grid.test_files = test_files or []
    grid.run_single_experiment(single_experiment=exp)


def main(argv=None):
    faulthandler.enable()
    argparser = argparse.ArgumentParser()
    argparser.add_argument("experiments_file", type=str,
                           help="yaml file for the experiments")
    argparser.add_argument("--gpu_id", type=int, default=0,
                           help="the card of a single-process run")
    argparser.add_argument("--num_jobs", type=int, default=1,
                           help="number of parallel experiment workers")
    argparser.add_argument("-d", "--date", type=str,
                           help="Date used to name the experiment dir")
    argparser.add_argument("--embed-only", action="store_true",
                           help="Run only the embedding (network already "
                                "trained)")
    argparser.add_argument("--test-files", nargs="+",
                           help="List of test yaml files (must contain "
                                "files, features and name attributes)")
    argparser.add_argument("--test-only", action="store_true",
                           help="Run only the testing")
    args = argparser.parse_args(argv)

    if args.date is not None:
        answer = input("Warning: using --date argument can overwrite "
                       "some files. Continue ? [y/n]")
        if not answer or answer[0].lower() != "y":
            print("Exiting")
            raise SystemExit(1)
    t1 = time.time()
    print("Start experiment")
    grid = GridSearch(input_file=args.experiments_file,
                      gpu_ids=args.gpu_id,
                      num_jobs=args.num_jobs,
                      date=args.date,
                      embed_only=args.embed_only,
                      test_files=args.test_files,
                      test_only=args.test_only)
    grid.run()
    print("The experiment took {} s ".format(time.time() - t1))


if __name__ == "__main__":
    main()
