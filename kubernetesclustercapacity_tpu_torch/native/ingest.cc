// Native pod-walk for the columnar snapshot packers (CPython extension).
//
// SURVEY.md §2.1 names the snapshot packer (C3) + quantity codecs (C6/C7)
// as the natural native component; the codecs live in capacity.cc and this
// file supplies the packer's hot loop: the ~100k-pod dict walk that
// collects, per container, an interned "quad" code (the tuple of its
// quantity strings) plus its grouping index.  Everything numeric stays in
// Python/numpy (the LUT parse + scatter-adds are already vectorized);
// everything the interpreter made slow (per-dict method dispatch on ~10
// lookups x ~300k containers) runs here at C speed with the SAME dict
// operations, so insertion orders, defaults, and grouping are identical
// to the pure-Python walks in snapshot.py (the tests pin this).
//
// Semantics stay single-sourced: phase sets come in from the caller
// (oracle._EXCLUDED_PHASES / snapshot._STRICT_TERMINATED), and any object
// that is not JSON-shaped (non-dict pod/resources, non-list containers,
// non-str nodeName...) makes the walk return None so the caller reruns
// the pure-Python loop and raises exactly what it always raised.
//
// Reference walk mirrors snapshot._pack_reference's loop
// (ClusterCapacity.go:232-299 semantics: field-selector by phase, usage
// grouped by raw nodeName string including the phantom "" group); strict
// walk mirrors snapshot._pack_strict's loop (assigned & non-terminated
// pods, containers + initContainers collected separately).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <new>
#include <vector>

namespace {

// Pre-built key strings (PyDict_GetItemString allocates a fresh unicode
// per call; these are made once at module init).
PyObject *s_phase, *s_nodeName, *s_containers, *s_initContainers;
PyObject *s_resources, *s_requests, *s_limits, *s_cpu, *s_memory, *s_zero,
    *s_empty;

// Fallback signal: the structure wasn't JSON-shaped; caller must rerun
// the pure-Python walk (which raises its usual exceptions on such input).
struct Fallback {};
// Real error: a Python exception is set and must propagate.
struct Raised {};

// RAII strong reference: several dict/set operations below can execute
// arbitrary Python (__hash__/__eq__ of hostile keys colliding with ours),
// which may mutate the containers we borrowed from — every object we keep
// using across such a call is pinned for the duration.
struct Ref {
  PyObject* o;
  explicit Ref(PyObject* obj) : o(obj) { Py_XINCREF(o); }
  ~Ref() { Py_XDECREF(o); }
  Ref(const Ref&) = delete;
  Ref& operator=(const Ref&) = delete;
};

PyObject* dict_get(PyObject* dict, PyObject* key) {
  // dict.get(key) -> borrowed ref or nullptr (absent).
  PyObject* v = PyDict_GetItemWithError(dict, key);
  if (v == nullptr && PyErr_Occurred()) throw Raised{};
  return v;
}

// pod.get(key, {}).get(...) chains: returns borrowed dict or nullptr for
// "empty"; anything present-but-not-a-dict falls back (the Python walk
// then raises AttributeError/TypeError exactly as it always did).
PyObject* get_dict_or_empty(PyObject* owner, PyObject* key) {
  PyObject* v = dict_get(owner, key);
  if (v == nullptr) return nullptr;
  if (!PyDict_CheckExact(v)) throw Fallback{};
  return v;
}

Py_ssize_t intern_code(PyObject* interned, PyObject* quad) {
  // interned.setdefault(quad, len(interned)) with quad consumed.
  PyObject* def = PyLong_FromSsize_t(PyDict_Size(interned));
  if (def == nullptr) { Py_DECREF(quad); throw Raised{}; }
  PyObject* got = PyDict_SetDefault(interned, quad, def);  // borrowed
  Py_DECREF(def);
  Py_DECREF(quad);
  if (got == nullptr) throw Raised{};
  Py_ssize_t code = PyLong_AsSsize_t(got);
  if (code == -1 && PyErr_Occurred()) throw Raised{};
  return code;
}

PyObject* vec_to_bytes(const std::vector<int64_t>& v) {
  return PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(v.data()),
      static_cast<Py_ssize_t>(v.size() * sizeof(int64_t)));
}

// Shared container-quad collection.  cpu slots take ``cpu_default``
// (the "0" string in reference mode, None in strict mode) when ABSENT;
// an explicit null stays None, exactly like dict.get's default rules.
// ``extended`` (strict only) appends req.get(name) per extended resource.
PyObject* build_quad(PyObject* container, PyObject* cpu_default,
                     PyObject* extended /* tuple or nullptr */) {
  if (!PyDict_CheckExact(container)) throw Fallback{};
  // Every fetched dict is pinned BEFORE the next hostile-capable lookup:
  // a colliding key's __eq__ during the s_requests lookup must not be
  // able to free res (via del container['resources']), nor the s_limits
  // lookup free req — each object's only other strong ref is the parent
  // dict slot such a callback can clear.
  PyObject* res = dict_get(container, s_resources);
  Ref pin_res(res);
  PyObject* req = nullptr;
  PyObject* lim = nullptr;
  if (res != nullptr) {
    if (!PyDict_CheckExact(res)) throw Fallback{};
    req = get_dict_or_empty(res, s_requests);
  }
  Ref pin_req(req);
  if (res != nullptr) {
    lim = get_dict_or_empty(res, s_limits);
  }
  Ref pin_lim(lim);
  Py_ssize_t n_ext = extended ? PyTuple_GET_SIZE(extended) : 0;
  PyObject* quad = PyTuple_New(4 + n_ext);
  if (quad == nullptr) throw Raised{};
  try {
    PyObject* v;
    v = req ? dict_get(req, s_cpu) : nullptr;
    if (v == nullptr) v = cpu_default;
    Py_INCREF(v); PyTuple_SET_ITEM(quad, 0, v);
    v = lim ? dict_get(lim, s_cpu) : nullptr;
    if (v == nullptr) v = cpu_default;
    Py_INCREF(v); PyTuple_SET_ITEM(quad, 1, v);
    v = req ? dict_get(req, s_memory) : nullptr;
    if (v == nullptr) v = Py_None;
    Py_INCREF(v); PyTuple_SET_ITEM(quad, 2, v);
    v = lim ? dict_get(lim, s_memory) : nullptr;
    if (v == nullptr) v = Py_None;
    Py_INCREF(v); PyTuple_SET_ITEM(quad, 3, v);
    for (Py_ssize_t e = 0; e < n_ext; ++e) {
      v = req ? dict_get(req, PyTuple_GET_ITEM(extended, e)) : nullptr;
      if (v == nullptr) v = Py_None;
      Py_INCREF(v); PyTuple_SET_ITEM(quad, 4 + e, v);
    }
  } catch (...) {
    Py_DECREF(quad);  // unfilled slots are NULL — safe to deallocate
    throw;
  }
  return quad;
}

// walk_reference(pods: list, excluded_phases: set-like)
//   -> (name_gid: dict, interned: dict, pod_gids, c_gids, c_codes) | None
PyObject* walk_reference(PyObject*, PyObject* args) {
  PyObject *pods, *excluded;
  if (!PyArg_ParseTuple(args, "OO", &pods, &excluded)) return nullptr;
  if (!PyList_CheckExact(pods)) Py_RETURN_NONE;

  PyObject* interned = PyDict_New();
  PyObject* name_gid = PyDict_New();
  if (interned == nullptr || name_gid == nullptr) {
    Py_XDECREF(interned); Py_XDECREF(name_gid);
    return nullptr;
  }
  std::vector<int64_t> pod_gids, c_gids, c_codes;

  try {
    // List sizes re-read per iteration and items pinned while hostile
    // __hash__/__eq__ callbacks could run: a callback that mutates the
    // fixture mid-walk gets odd-but-memory-safe behavior, never UAF.
    for (Py_ssize_t p = 0; p < PyList_GET_SIZE(pods); ++p) {
      Ref pod(PyList_GET_ITEM(pods, p));
      if (!PyDict_CheckExact(pod.o)) throw Fallback{};
      Ref phase(dict_get(pod.o, s_phase));
      int ex = PySet_Contains(excluded, phase.o ? phase.o : Py_None);
      if (ex < 0) throw Raised{};
      if (ex) continue;  // does not survive the field selector

      Ref node_name(dict_get(pod.o, s_nodeName));
      PyObject* def = PyLong_FromSsize_t(PyDict_Size(name_gid));
      if (def == nullptr) throw Raised{};
      PyObject* got = PyDict_SetDefault(
          name_gid, node_name.o ? node_name.o : s_empty, def);
      Py_DECREF(def);
      if (got == nullptr) throw Raised{};
      Py_ssize_t gid = PyLong_AsSsize_t(got);
      if (gid == -1 && PyErr_Occurred()) throw Raised{};
      pod_gids.push_back(gid);

      Ref containers(dict_get(pod.o, s_containers));
      if (containers.o == nullptr) continue;
      if (!PyList_CheckExact(containers.o)) throw Fallback{};
      for (Py_ssize_t ci = 0; ci < PyList_GET_SIZE(containers.o); ++ci) {
        Ref container(PyList_GET_ITEM(containers.o, ci));
        PyObject* quad = build_quad(container.o, s_zero, nullptr);
        c_gids.push_back(gid);
        c_codes.push_back(intern_code(interned, quad));
      }
    }
  } catch (Fallback&) {
    Py_DECREF(interned); Py_DECREF(name_gid);
    Py_RETURN_NONE;
  } catch (Raised&) {
    Py_DECREF(interned); Py_DECREF(name_gid);
    return nullptr;
  } catch (const std::bad_alloc&) {
    Py_DECREF(interned); Py_DECREF(name_gid);
    PyErr_NoMemory();
    return nullptr;
  }

  PyObject* out = Py_BuildValue(
      "(NNNNN)", name_gid, interned, vec_to_bytes(pod_gids),
      vec_to_bytes(c_gids), vec_to_bytes(c_codes));
  if (out == nullptr) return nullptr;  // N stole what it could; give up
  return out;
}

// walk_strict(pods: list, index: dict[str, int], terminated: set-like,
//             extended: tuple[str, ...])
//   -> (interned, pod_nodes, c_pod, c_codes, i_pod, i_codes) | None
PyObject* walk_strict(PyObject*, PyObject* args) {
  PyObject *pods, *index, *terminated, *extended;
  if (!PyArg_ParseTuple(args, "OOOO", &pods, &index, &terminated, &extended))
    return nullptr;
  if (!PyList_CheckExact(pods) || !PyDict_CheckExact(index) ||
      !PyTuple_CheckExact(extended))
    Py_RETURN_NONE;

  PyObject* interned = PyDict_New();
  if (interned == nullptr) return nullptr;
  std::vector<int64_t> pod_nodes, c_pod, c_codes, i_pod, i_codes;

  try {
    // Same pinning/re-read discipline as walk_reference — see there.
    for (Py_ssize_t p = 0; p < PyList_GET_SIZE(pods); ++p) {
      Ref pod(PyList_GET_ITEM(pods, p));
      if (!PyDict_CheckExact(pod.o)) throw Fallback{};
      Ref node_name(dict_get(pod.o, s_nodeName));
      if (node_name.o == nullptr) continue;  // .get("nodeName", "") falsy
      if (!PyUnicode_CheckExact(node_name.o)) throw Fallback{};
      if (PyUnicode_GetLength(node_name.o) == 0) continue;
      PyObject* row = dict_get(index, node_name.o);
      if (row == nullptr) continue;  // not a known node
      Py_ssize_t row_i = PyLong_AsSsize_t(row);
      if (row_i == -1 && PyErr_Occurred()) throw Raised{};

      Ref phase(dict_get(pod.o, s_phase));
      int term = PySet_Contains(terminated, phase.o ? phase.o : Py_None);
      if (term < 0) throw Raised{};
      if (term) continue;

      int64_t pid = static_cast<int64_t>(pod_nodes.size());
      pod_nodes.push_back(row_i);

      struct Kind { PyObject* key; std::vector<int64_t>* pods_v;
                    std::vector<int64_t>* codes_v; };
      const Kind kinds[2] = {{s_containers, &c_pod, &c_codes},
                             {s_initContainers, &i_pod, &i_codes}};
      for (const Kind& k : kinds) {
        Ref seq(dict_get(pod.o, k.key));
        if (seq.o == nullptr) continue;
        if (!PyList_CheckExact(seq.o)) throw Fallback{};
        for (Py_ssize_t ci = 0; ci < PyList_GET_SIZE(seq.o); ++ci) {
          Ref container(PyList_GET_ITEM(seq.o, ci));
          PyObject* quad = build_quad(container.o, Py_None, extended);
          k.pods_v->push_back(pid);
          k.codes_v->push_back(intern_code(interned, quad));
        }
      }
    }
  } catch (Fallback&) {
    Py_DECREF(interned);
    Py_RETURN_NONE;
  } catch (Raised&) {
    Py_DECREF(interned);
    return nullptr;
  } catch (const std::bad_alloc&) {
    Py_DECREF(interned);
    PyErr_NoMemory();
    return nullptr;
  }

  return Py_BuildValue(
      "(NNNNNN)", interned, vec_to_bytes(pod_nodes), vec_to_bytes(c_pod),
      vec_to_bytes(c_codes), vec_to_bytes(i_pod), vec_to_bytes(i_codes));
}

PyMethodDef methods[] = {
    {"walk_reference", walk_reference, METH_VARARGS,
     "Reference-semantics columnar pod walk; None => caller falls back."},
    {"walk_strict", walk_strict, METH_VARARGS,
     "Strict-semantics columnar pod walk; None => caller falls back."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_kccap_ingest",
                      "Native columnar pod walk for the snapshot packers.",
                      -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__kccap_ingest(void) {
  s_phase = PyUnicode_InternFromString("phase");
  s_nodeName = PyUnicode_InternFromString("nodeName");
  s_containers = PyUnicode_InternFromString("containers");
  s_initContainers = PyUnicode_InternFromString("initContainers");
  s_resources = PyUnicode_InternFromString("resources");
  s_requests = PyUnicode_InternFromString("requests");
  s_limits = PyUnicode_InternFromString("limits");
  s_cpu = PyUnicode_InternFromString("cpu");
  s_memory = PyUnicode_InternFromString("memory");
  s_zero = PyUnicode_InternFromString("0");
  s_empty = PyUnicode_InternFromString("");
  if (!s_phase || !s_nodeName || !s_containers || !s_initContainers ||
      !s_resources || !s_requests || !s_limits || !s_cpu || !s_memory ||
      !s_zero || !s_empty)
    return nullptr;
  return PyModule_Create(&module);
}
